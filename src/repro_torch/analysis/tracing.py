"""RT2xx — host-sync hygiene of the functions on the decode step.

The JAX package's RA2xx rules check jitted functions, whose parameters are
tracers. The port has no tracer: its decode step is eager Python that
launches kernels, and what breaks it is a host sync (the thread waits for
the device, and a CUDA graph cannot hold the call) or a tensor whose shape
changes from step to step (each new shape is a new graph capture). So the
rules run over the functions marked as being on the step, and follow which
of their values are tensors.

Marking. A ``# step:`` comment on a ``def``'s signature, or on comment
lines between the signature and the body (continuation comment lines
merge, as for ``# held:``), puts the function on the decode step; the
text after it says why. Its parameters are host values unless named in a
``tensors=a,b,c`` item of the comment, which may also name attributes of
``self`` that hold tensors (``tensors=_cache,_stacked``)::

    def step(self) -> bool:  # step: the continuous decode step;
                             # tensors=_cache,_stacked

Nested functions and lambdas are checked with the enclosing function.

Which values are tensors: the named parameters and ``self`` attributes,
``self._d_*`` (the engines' device-resident row state), the results of
``torch.*`` calls (but ``torch.cuda.*``, ``torch.device`` and other host
calls), of calls to names ending in ``_fn`` (the engines' step functions),
of methods, indexing and arithmetic on a tensor, and names assigned from
any of these. ``.shape``/``.ndim``/``.dtype``/``.device``, ``len()``,
``.size()``/``.numel()``/``.stride()``/``.data_ptr()`` and ``is``/``in``
tests give host values without a sync; so do ``.cpu()``/``.item()``/
``.tolist()``/``.numpy()``, after the sync they are flagged for.

  RT201  ``if`` / ``while`` / ``assert`` / ternary on a tensor value
  RT202  a host sync: ``.item()`` / ``.cpu()`` / ``.tolist()`` /
         ``.numpy()`` of a tensor, ``float()`` / ``int()`` / ``bool()`` /
         ``np.asarray()`` / ``np.array()`` of one, ``torch.cuda.synchronize``,
         ``<stream or event>.synchronize()``, a host-to-device copy from
         pageable memory (``torch.from_numpy(...).to(dev)``,
         ``.copy_(torch.from_numpy(...))``, ``torch.as_tensor(...,
         device=dev)``: torch waits for the stream after such a copy), and a
         call of a function or ``self`` method whose own body does one of
         the last four (a sync helper, such as ``models.common.synchronize``,
         the engine's ``_sync_stream`` or its ``_tensor`` upload)
  RT203  an allocation (``torch.empty/zeros/ones/full/arange/rand/randn/
         randint/tensor/as_tensor/from_numpy``, ``.new_*``, the engines'
         ``_tensor``) whose arguments derive from an unbucketed ``len(...)``
         — RA204's test: shapes routed through ``*bucket*`` / ``*pad*`` /
         ``pages_for`` or pow2 growth are bucketed

The step's intended sync (reading the sampled tokens) carries
``# noqa: RT202`` with its reason.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Union

from .core import Finding, SourceFile

_FnNode = Union[ast.FunctionDef, ast.Lambda]

_STEP_RE = re.compile(r"^step:", re.I)
_TENSORS_RE = re.compile(r"tensors=(\w+(?:\s*,\s*\w+)*)")

_HOST_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta",
               "requires_grad", "layout", "is_sparse", "placements",
               "device_mesh", "type"}
_HOST_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                 "data_ptr", "stride", "storage_offset", "is_contiguous",
                 "get_device", "is_floating_point", "untyped_storage",
                 "record_stream", "synchronize", "wait_stream",
                 "wait_event", "record", "cuda_stream"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_HOST_CALLS = {"len", "isinstance", "type", "range", "enumerate", "zip",
               "hasattr", "getattr", "id", "str", "repr"}
_TORCH_HOST = {"device", "dtype", "finfo", "iinfo", "Size", "is_tensor",
               "is_grad_enabled", "no_grad", "inference_mode",
               "enable_grad", "get_default_dtype", "set_grad_enabled",
               "Generator", "is_floating_point", "numel", "manual_seed"}
_TORCH_HOST_MODULES = ("cuda", "distributed", "_C", "backends", "utils",
                       "autograd", "profiler")
_ALLOC_FUNCS = {"empty", "zeros", "ones", "full", "arange", "rand", "randn",
                "randint", "empty_strided", "tensor", "as_tensor",
                "from_numpy"}
_ALLOC_METHODS = {"new_empty", "new_zeros", "new_ones", "new_full",
                  "new_tensor", "_tensor"}
_BUCKET_MARKERS = ("bucket", "pad", "pages_for")
_CAST_FUNCS = {"int", "float", "bool"}


def _dotted(node: ast.expr) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _step_spec(src: SourceFile, fn: ast.FunctionDef):
    """(on the step?, the names of its tensor parameters and attributes)
    from a ``# step:`` comment on the signature's lines or on comment
    lines between the signature and the body."""
    for line in range(fn.lineno, fn.body[0].lineno):
        text = src.comment_at(line)
        if _STEP_RE.match(text):
            names: Set[str] = set()
            for m in _TENSORS_RE.finditer(text):
                names.update(n.strip() for n in m.group(1).split(","))
            return True, names - {""}
    return False, set()


def _host_tensor(node: ast.expr) -> bool:
    """A tensor made on the host from host data: ``torch.from_numpy(...)``,
    or ``torch.tensor/as_tensor(...)`` with no ``device``."""
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func) or ""
    if name == "torch.from_numpy":
        return True
    return name in ("torch.tensor", "torch.as_tensor") and not any(
        k.arg == "device" for k in node.keywords)


def _upload(node: ast.Call) -> Optional[str]:
    """What a host-to-device copy from pageable memory looks like: such a
    copy waits for the stream (``set_sync_debug_mode`` reports it)."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in ("to", "cuda") and _host_tensor(f.value):
        return f"`{_dotted(f.value.func)}(...).{f.attr}()`"
    if f.attr == "copy_" and node.args and _host_tensor(node.args[0]):
        return f"`.copy_({_dotted(node.args[0].func)}(...))`"
    name = _dotted(f) or ""
    if name in ("torch.tensor", "torch.as_tensor"):
        for k in node.keywords:
            if k.arg == "device" and not (isinstance(k.value, ast.Constant)
                                          and k.value.value == "cpu"):
                return f"`{name}(..., device=...)`"
    return None


def _is_sync_call(node: ast.Call) -> bool:
    """``torch.cuda.synchronize(...)``, ``<x>.synchronize()`` or an
    upload from pageable host memory."""
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "synchronize") \
        or _upload(node) is not None


def _sync_helpers(files: List[SourceFile]) -> Set[str]:
    """Functions and methods whose own body synchronizes: called by name
    (a module-level function) or as ``self.<name>`` (a method)."""
    out: Set[str] = set()
    for src in files:
        defs = list(src.tree.body)
        for node in src.tree.body:
            if isinstance(node, ast.ClassDef):
                defs += node.body
        for node in defs:
            if isinstance(node, ast.FunctionDef) and any(
                    isinstance(n, ast.Call) and _is_sync_call(n)
                    for n in ast.walk(node)):
                out.add(node.name)
    return out


class _Tensors:
    """Which expressions hold tensors, relative to tracked names."""

    def __init__(self, names: Set[str], attrs: Set[str]):
        self.names = names          # local names holding tensors
        self.attrs = attrs          # self attributes holding tensors

    def expr(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in self.attrs or node.attr.startswith("_d_")
            return self.expr(node.value)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.expr(node.left) or \
                any(self.expr(c) for c in node.comparators)
        if isinstance(node, ast.Subscript):
            return self.expr(node.value)
        if isinstance(node, (ast.BinOp,)):
            return self.expr(node.left) or self.expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.expr(node.body) or self.expr(node.orelse)
        return False             # containers, lambdas, comprehensions

    def _call(self, node: ast.Call) -> bool:
        f = node.func
        name = _dotted(f) or ""
        if isinstance(f, ast.Name):
            if f.id in _HOST_CALLS or f.id in _CAST_FUNCS:
                return False
            return f.id.endswith("_fn")
        if not isinstance(f, ast.Attribute):
            return False
        if name.startswith("torch.") or name.startswith("F."):
            parts = name.split(".")
            if len(parts) > 2 and parts[1] in _TORCH_HOST_MODULES:
                return False
            return parts[-1] not in _TORCH_HOST
        if f.attr.endswith("_fn"):
            return True
        if f.attr in _HOST_METHODS or f.attr in _SYNC_METHODS:
            return False
        return self.expr(f.value)

    def first_name(self, node: ast.expr) -> str:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id in self.names:
                return n.id
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                    and self.expr(n):
                return ast.unparse(n)
        return ast.unparse(node)[:40]


class _StepChecker:
    """RT201/RT202 over one decode-step function body."""

    def __init__(self, src: SourceFile, fn: _FnNode, tensors: _Tensors,
                 helpers: Set[str], findings: List[Finding]):
        self.src = src
        self.fn = fn
        self.t = tensors
        self.helpers = helpers
        self.findings = findings

    def _emit(self, rule: str, line: int, msg: str):
        self.findings.append(Finding(rule, self.src.rel, line, msg))

    def run(self):
        if isinstance(self.fn, ast.Lambda):
            self._exprs(self.fn.body)
            return
        for stmt in self.fn.body:
            self._stmt(stmt)

    def _nested(self, fn: _FnNode):
        sub = _StepChecker(self.src, fn, _Tensors(set(self.t.names),
                                                  self.t.attrs),
                           self.helpers, self.findings)
        sub.run()

    def _stmt(self, stmt: ast.stmt):
        t = self.t
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._nested(stmt)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            if t.expr(stmt.test):
                kw = "if" if isinstance(stmt, ast.If) else "while"
                self._emit("RT201", stmt.lineno,
                           f"Python `{kw}` on tensor value "
                           f"`{t.first_name(stmt.test)}` in a decode-step "
                           f"function")
            self._exprs(stmt.test)
        elif isinstance(stmt, ast.Assert):
            if t.expr(stmt.test):
                self._emit("RT201", stmt.lineno,
                           f"`assert` on tensor value "
                           f"`{t.first_name(stmt.test)}` in a decode-step "
                           f"function")
            self._exprs(stmt.test)
        elif isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._assign(stmt)
        elif isinstance(stmt, ast.For):
            self._exprs(stmt.iter)
            if t.expr(stmt.iter):
                for n in ast.walk(stmt.target):
                    if isinstance(n, ast.Name):
                        t.names.add(n.id)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self._exprs(item.context_expr)
        elif isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self._exprs(stmt.value)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            elif isinstance(child, ast.excepthandler):
                for s in child.body:
                    self._stmt(s)

    def _assign(self, stmt):
        t = self.t
        value = stmt.value
        if value is not None:
            self._exprs(value)
        tensor = value is not None and t.expr(value)
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        for tgt in targets:
            elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                else [tgt]
            for e in elts:
                if isinstance(e, ast.Starred):
                    e = e.value
                if isinstance(e, ast.Name):
                    if tensor:
                        t.names.add(e.id)
                    elif not isinstance(stmt, ast.AugAssign):
                        t.names.discard(e.id)

    def _exprs(self, expr: ast.expr):
        t = self.t
        stack: List[ast.AST] = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Lambda):
                self._nested(node)
                continue
            if isinstance(node, ast.IfExp) and t.expr(node.test):
                self._emit("RT201", node.lineno,
                           f"ternary on tensor value "
                           f"`{t.first_name(node.test)}` in a decode-step "
                           f"function")
            elif isinstance(node, ast.Call):
                self._sync(node)
            stack.extend(ast.iter_child_nodes(node))

    def _sync(self, node: ast.Call):
        t = self.t
        f = node.func
        name = _dotted(f) or ""
        if isinstance(f, ast.Name):
            if f.id in _CAST_FUNCS and node.args and t.expr(node.args[0]):
                self._emit("RT202", node.lineno,
                           f"`{f.id}()` of tensor value "
                           f"`{t.first_name(node.args[0])}` syncs the host "
                           f"with the device")
            elif f.id in self.helpers:
                self._emit("RT202", node.lineno,
                           f"`{f.id}()` waits for the device (a sync "
                           f"helper)")
            return
        if not isinstance(f, ast.Attribute):
            return
        up = _upload(node)
        if up is not None:
            self._emit("RT202", node.lineno,
                       f"{up}: a host-to-device copy from pageable memory "
                       f"waits for the stream")
        elif name == "torch.cuda.synchronize":
            self._emit("RT202", node.lineno,
                       "`torch.cuda.synchronize()` waits for the whole "
                       "device")
        elif f.attr == "synchronize":
            self._emit("RT202", node.lineno,
                       f"`{ast.unparse(f)[:60]}()` waits for a stream or "
                       f"event")
        elif f.attr in _SYNC_METHODS and t.expr(f.value):
            self._emit("RT202", node.lineno,
                       f"`.{f.attr}()` of tensor value "
                       f"`{t.first_name(f.value)}` syncs the host with the "
                       f"device")
        elif name in ("np.asarray", "np.array", "numpy.asarray",
                      "numpy.array") and node.args and t.expr(node.args[0]):
            self._emit("RT202", node.lineno,
                       f"`{name}()` of tensor value "
                       f"`{t.first_name(node.args[0])}` syncs the host with "
                       f"the device")
        elif f.attr in self.helpers and isinstance(f.value, ast.Name):
            self._emit("RT202", node.lineno,
                       f"`{name}()` waits for the device (a sync helper)")


def _alloc_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    name = _dotted(f) or f.attr
    if name.startswith("torch.") and f.attr in _ALLOC_FUNCS \
            and name.count(".") == 1:
        return name
    if f.attr in _ALLOC_METHODS:
        return f".{f.attr}"
    return None


def _hazards(src: SourceFile, fn: ast.FunctionDef,
             findings: List[Finding]):
    """RT203 over one decode-step function (and what it nests)."""
    assign: Dict[str, ast.expr] = {}
    pow2: Set[str] = set()
    for s in ast.walk(fn):
        if isinstance(s, ast.Assign) and len(s.targets) == 1 \
                and isinstance(s.targets[0], ast.Name):
            assign[s.targets[0].id] = s.value
        elif isinstance(s, ast.AugAssign) and isinstance(s.target, ast.Name) \
                and isinstance(s.op, ast.Mult):
            pow2.add(s.target.id)

    def hazardous(expr: ast.expr, seen: Set[str], depth: int) -> bool:
        stack: List[ast.AST] = [expr]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.List, ast.ListComp)):
                continue       # a data literal: its length is a slot count
            if isinstance(n, ast.Call):
                fname = (n.func.id if isinstance(n.func, ast.Name)
                         else n.func.attr
                         if isinstance(n.func, ast.Attribute) else "")
                if any(m in fname for m in _BUCKET_MARKERS):
                    continue
                if fname == "len":
                    return True
            if isinstance(n, ast.Name) and n.id not in seen \
                    and n.id not in pow2 and depth < 4 and n.id in assign:
                if hazardous(assign[n.id], seen | {n.id}, depth + 1):
                    return True
            stack.extend(ast.iter_child_nodes(n))
        return False

    reported: Set[int] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) or node.lineno in reported:
            continue
        name = _alloc_name(node)
        if name is None:
            continue
        for arg in list(node.args) + [k.value for k in node.keywords]:
            if hazardous(arg, set(), 0):
                reported.add(node.lineno)
                findings.append(Finding(
                    "RT203", src.rel, node.lineno,
                    f"`{name}` allocates a tensor whose shape derives from "
                    f"unbucketed `len(...)` — each new length is a new "
                    f"CUDA-graph capture"))
                break


def step_functions(src: SourceFile):
    """(function node, tensor names) of every ``# step:`` function."""
    out = []
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            on, names = _step_spec(src, node)
            if on:
                out.append((node, names))
    return out


def check(files: List[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    helpers = _sync_helpers(files)
    for src in files:
        marked = step_functions(src)
        inner = {id(n) for fn, _ in marked for n in ast.walk(fn)
                 if n is not fn}
        for fn, names in marked:
            if id(fn) in inner:      # checked with the function it nests in
                continue
            params = {a.arg for a in fn.args.posonlyargs + fn.args.args
                      + fn.args.kwonlyargs}
            _StepChecker(src, fn, _Tensors(names & params, names - params),
                         helpers, findings).run()
            _hazards(src, fn, findings)
    return findings
