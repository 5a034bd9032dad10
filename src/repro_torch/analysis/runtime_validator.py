"""Runtime validators that cross-check the port's static model.

``LockOrderRecorder`` — a copy of the reference's, rooted at
``src/repro_torch``: it patches the ``threading.Lock/RLock/Condition``
factories so every lock CREATED FROM the port's code (the immediate caller
frame lives under ``src/repro_torch``) is wrapped in a recording proxy.
Each acquisition while other locks are held records an order edge keyed
by the locks' creation sites (``file:line`` — exactly the lock ids of the
static ``LockModel``). ``check_against(model)`` then verifies (a) every
observed lock is statically known and (b) no observed edge reverses a
path in the merged static+observed graph.

``RecompileSentinel`` — the reference counts jit cache misses; the port
has no jit, so the sentinel counts what would break a steady state of its
eager decode step, and what a CUDA-graph capture of it would have to
rebuild:
  - new entries of the kernels' launch-plan caches (the ``lru_cache``s of
    ``kernels/gqa_decode.decode_plan``, ``kernels/sgmv.sgmv_plan`` and
    ``_plan_args``, ``kernels/token_logprob.forward_plan``; a miss is a
    new entry), reported as ``plan:<name>``;
  - kernel library loads (``kernels/_build``'s ``_BUILDER.loads``), as
    ``library loads``;
  - new argument signatures (tensor shapes, dtypes and devices) of the
    engine's step functions wrapped by ``track_engine``, as
    ``signature:<attr>``: each new one is a new graph capture;
  - on the card, the synchronizing calls of a step, counted through
    ``torch.cuda.set_sync_debug_mode("warn")`` (``step_syncs``), by the
    frame of the port that made them.
After a warm-up ``mark()``, ``new_compiles()`` must stay empty through
steady-state decode. Both are debug instruments used by the tests and
``chip_smoke.py``; production code never imports them.
"""
from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

_FACTORIES = ("Lock", "RLock", "Condition")
_REAL = {name: getattr(threading, name) for name in _FACTORIES}


def _creation_site(root: str) -> Optional[Tuple[str, int]]:
    """(normalized file, line) of the nearest stack frame under `root`,
    or None when the lock is created by stdlib internals (Event, Queue,
    ...) — those are not part of the static model and stay unproxied."""
    stack = traceback.extract_stack()
    # skip this helper + the factory wrapper frames at the top
    for frame in reversed(stack[:-2]):
        posix = frame.filename.replace("\\", "/")
        idx = posix.find(root)
        if idx >= 0 and "/analysis/" not in posix[idx:]:
            return posix[idx:], frame.lineno
        if "/threading.py" in posix or "/queue.py" in posix \
                or "/concurrent/" in posix:
            return None
        # any non-repo frame between us and the factory means the lock
        # belongs to that library, not to repo code
        return None
    return None


class _LockProxy:
    """Recording wrapper around a real Lock/RLock. Delegates the private
    Condition protocol (`_is_owned`/`_release_save`/`_acquire_restore`)
    so ``threading.Condition(proxy)`` works, including RLock recursion
    save/restore around ``wait()``."""

    def __init__(self, real, site: Tuple[str, int],
                 recorder: "LockOrderRecorder"):
        self._real = real
        self.site = f"{site[0]}:{site[1]}"
        self._recorder = recorder

    def acquire(self, blocking=True, timeout=-1):
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._recorder._note_acquire(self)
        return ok

    def release(self):
        self._recorder._note_release(self)
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked()

    # Condition protocol -------------------------------------------------
    def _is_owned(self):
        if hasattr(self._real, "_is_owned"):
            return self._real._is_owned()
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def _release_save(self):
        self._recorder._note_release(self, full=True)
        if hasattr(self._real, "_release_save"):
            return self._real._release_save()
        self._real.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._real, "_acquire_restore"):
            self._real._acquire_restore(state)
        else:
            self._real.acquire()
        self._recorder._note_acquire(self)


class LockOrderRecorder:
    """Context manager: record actual lock-acquisition order of every
    lock created by repo code while active."""

    def __init__(self, root: str = "src/repro_torch"):
        self.root = root
        self.edges: Dict[Tuple[str, str], int] = {}   # (a, b) -> count
        self.sites: Set[str] = set()
        self._tls = threading.local()
        self._elock = _REAL["Lock"]()

    # -- factory patching ------------------------------------------------
    def __enter__(self):
        rec = self

        def make(kind):
            real_factory = _REAL[kind]

            def factory(*args, **kwargs):
                site = _creation_site(rec.root)
                if site is None:
                    return real_factory(*args, **kwargs)
                if kind == "Condition":
                    lock = args[0] if args else kwargs.get("lock")
                    if lock is None:
                        lock = _LockProxy(_REAL["RLock"](), site, rec)
                        rec.sites.add(lock.site)
                    return real_factory(lock)
                proxy = _LockProxy(real_factory(), site, rec)
                rec.sites.add(proxy.site)
                return proxy

            return factory

        for name in _FACTORIES:
            setattr(threading, name, make(name))
        return self

    def __exit__(self, *exc):
        for name in _FACTORIES:
            setattr(threading, name, _REAL[name])
        return False

    # -- recording -------------------------------------------------------
    def _held(self) -> List[List]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, proxy: _LockProxy):
        held = self._held()
        for entry in held:
            if entry[0] is proxy:
                entry[1] += 1          # reentrant re-acquire: no edge
                return
        if held:
            with self._elock:
                for entry in held:
                    if entry[0].site != proxy.site:
                        key = (entry[0].site, proxy.site)
                        self.edges[key] = self.edges.get(key, 0) + 1
        held.append([proxy, 1])

    def _note_release(self, proxy: _LockProxy, full: bool = False):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is proxy:
                held[i][1] = 0 if full else held[i][1] - 1
                if held[i][1] <= 0:
                    held.pop(i)
                return

    # -- cross-check -----------------------------------------------------
    def check_against(self, model) -> List[str]:
        """Violations of the static lock model: unknown lock sites and
        observed edges that close a cycle with the static graph."""
        problems: List[str] = []
        observed = set(self.edges)
        static_sites = model.sites()
        for a, b in sorted(observed):
            for site in (a, b):
                if site not in static_sites:
                    problems.append(
                        f"runtime lock at {site} unknown to the static "
                        f"model (missing threading.* assignment "
                        f"discovery?)")
        # merged graph must be acyclic: an observed edge b->a closing a
        # static (or observed) path a->b is an ordering inversion
        merged = observed | model.edge_pairs()

        def has_path(graph, a, b):
            seen, stack = set(), [a]
            while stack:
                n = stack.pop()
                if n == b:
                    return True
                if n in seen:
                    continue
                seen.add(n)
                stack.extend(y for (x, y) in graph if x == n)
            return False

        for a, b in sorted(observed):
            if has_path(merged - {(a, b)}, b, a):
                problems.append(
                    f"lock-order inversion: observed {a} -> {b} but the "
                    f"graph already orders {b} before {a}")
        return sorted(set(problems))


class RecompileSentinel:
    """Steady-state counter (module docstring): ``mark()`` after warm-up,
    then ``new_compiles()`` reports every new plan entry, library load and
    step-function signature since."""

    PLANS = (("gqa_decode", "decode_plan"), ("sgmv", "sgmv_plan"),
             ("sgmv", "_plan_args"), ("token_logprob", "forward_plan"))
    ENGINE_FNS = ("_step_fn", "_refill_fn", "_suffix_fn", "_splice_fn",
                  "_restore_fn", "_prefill_fn", "_first_fn")

    def __init__(self, plans: bool = True):
        self._fns: Dict[str, object] = {}
        self._base: Dict[str, int] = {}
        self._sigs: Dict[str, Set[tuple]] = {}
        self._sig_base: Dict[str, int] = {}
        if plans:
            self.track_plans()
        self.mark()

    # -- what is tracked -------------------------------------------------
    def track(self, name: str, fn) -> bool:
        """Track an ``lru_cache``d function's entries (its misses)."""
        if fn is None or not callable(getattr(fn, "cache_info", None)):
            return False
        self._fns[name] = fn
        self._base[name] = fn.cache_info().misses
        return True

    def track_plans(self) -> List[str]:
        import importlib
        out = []
        for mod, attr in self.PLANS:
            m = importlib.import_module(f"repro_torch.kernels.{mod}")
            if self.track(f"plan:{attr}", getattr(m, attr, None)):
                out.append(attr)
        return out

    def track_engine(self, engine) -> List[str]:
        """Wrap the engine's step functions so that each call records its
        arguments' signature; returns the attributes wrapped."""
        tracked = []
        for attr in self.ENGINE_FNS:
            fn = getattr(engine, attr, None)
            if fn is None or getattr(fn, "_sentinel", None) is self:
                continue
            key = f"signature:{attr}"
            seen = self._sigs.setdefault(key, set())

            def wrapped(*args, _fn=fn, _seen=seen, **kwargs):
                _seen.add(_signature((args, kwargs)))
                return _fn(*args, **kwargs)
            wrapped._sentinel = self
            setattr(engine, attr, wrapped)
            self._sig_base[key] = len(seen)
            tracked.append(attr)
        return tracked

    # -- counts ----------------------------------------------------------
    @staticmethod
    def _loads() -> int:
        from repro_torch.kernels import _build
        return _build._BUILDER.loads

    def mark(self):
        for name, fn in self._fns.items():
            self._base[name] = fn.cache_info().misses
        for key, seen in self._sigs.items():
            self._sig_base[key] = len(seen)
        self._base_loads = self._loads()

    def new_compiles(self) -> Dict[str, int]:
        out = {}
        for name, fn in self._fns.items():
            delta = fn.cache_info().misses - self._base[name]
            if delta > 0:
                out[name] = delta
        for key, seen in self._sigs.items():
            delta = len(seen) - self._sig_base.get(key, 0)
            if delta > 0:
                out[key] = delta
        loads = self._loads() - self._base_loads
        if loads > 0:
            out["library loads"] = loads
        return out

    def cache_sizes(self) -> Dict[str, int]:
        out = {name: fn.cache_info().currsize
               for name, fn in self._fns.items()}
        out.update({key: len(seen) for key, seen in self._sigs.items()})
        return out

    @staticmethod
    def step_syncs(fn, *args, **kwargs):
        """(fn's result, Counter of the synchronizing calls it made, by
        the innermost frame of the port above the call: "file:line
        function"). On the card only: ``set_sync_debug_mode("warn")``
        makes each such call warn, and the warnings are caught here."""
        import warnings
        from collections import Counter

        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("step_syncs needs the card: "
                               "set_sync_debug_mode reports CUDA syncs")
        where: Counter = Counter()

        def show(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" not in str(message):
                return          # e.g. the mode's own "prototype" notice
            site = "outside the port"
            for f in reversed(traceback.extract_stack()[:-1]):
                path = f.filename.replace("\\", "/")
                if "repro_torch/" in path and "/analysis/" not in path:
                    site = f"{path.split('src/')[-1]}:{f.lineno} {f.name}"
                    break
            where[site] += 1

        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return out, where


def _signature(tree) -> tuple:
    """The shapes, dtypes and devices of a call's tensor leaves, with the
    other leaves' types: what a CUDA graph of the call is keyed on."""
    import torch
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append((tuple(x.shape), str(x.dtype), str(x.device)))
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                out.append(k)
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            out.append(len(x))
            for v in x:
                walk(v)
        else:
            out.append(type(x).__name__)
    walk(tree)
    return tuple(out)
