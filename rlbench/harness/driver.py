"""Drives the system under test, ``repro_torch.core.runtime.MARLaaSRuntime``,
through one run of a cell: set-up, the pipeline's warm-up until every
tenant has committed once, the measured window, and the stop.

The runtime is configured as the cell says (continuous rollout over the
paged KV pool with the prefix cache, the asynchronous trainer at
max_staleness 1, one GRPO group a micro-batch) and fed by the benchmark's
traffic, weights and adapters. The probes below are the benchmark's own
instruments: wrappers that the harness puts, on the runtime's objects, in
place of the methods the runtime looks up (``cengine.step``,
``cengine._step_fn``, ``_train_one``, ``_build_requests``,
``_handle_completion``) and, in a traced run, around the kernels' entry
points where the program looks them up. They time on the host clock and
record what the host already holds; none of them waits for the card.
"""
from __future__ import annotations

import gc
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import yardstick as ys
from .cell import Cell
from .traffic import Traffic

CHECK_TENANTS = 2       # tenants the correctness check follows
CHECK_UPDATES = 3       # the updates it follows of each
CHECK_WAIT_S = 120.0    # the longest the runtime runs on past the close
COUNTERS = ("decode_steps", "sampled_tokens", "prefill_tokens",
            "prefix_hits", "prefix_hit_tokens", "pool_exhausted",
            "preemptions", "completions")


@dataclass
class Commit:
    t0: float
    t1: float
    tid: str
    tokens: int
    lengths: List[int]


Segments = List[Tuple[int, int]]      # (first completion token, version)


@dataclass
class TrainRecord:
    """A tenant's update: its batch as the trainer got it, the adapter
    versions that decoded each row's tokens, and what the program made of
    it (the first update's optimizer moment, the third's adapters)."""
    tid: str
    version: int                  # the oldest version the rows came from
    tokens: np.ndarray
    prompt_lens: np.ndarray
    total_lens: np.ndarray
    rewards: np.ndarray
    loss_mask: np.ndarray
    segments: List[Segments]      # per row: where each version took over
    metrics: Dict[str, Any] = field(default_factory=dict)
    adapters: Any = None          # the committed tree after this update
    opt_state: Any = None


@dataclass
class Served:
    """A finished request as the program served it, cut
    to the tokens decoded under one adapter version: a new version installed
    in the tenant's slot while the row was resident ends the part that one
    version served (its cache holds the old version's keys), and a row
    queued across an install is left out."""
    tid: str
    version: int                  # the version its slot held at admission
    greedy: bool
    prompt_len: int
    tokens: List[int]             # prompt + the tokens one version served
    logprobs: List[float]
    finished_at: float


class Probes:
    """The benchmark's instruments on one runtime."""

    def __init__(self, rt, traffic: Traffic, trace: bool):
        self.rt = rt
        self.traffic = traffic
        self.trace = trace
        self.lock = threading.Lock()
        self.first_commit: Dict[str, float] = {}
        self.commits: List[Commit] = []
        self.steps: List[Tuple[float, float]] = []       # decode step calls
        self.decodes: List[Tuple[float, int, float, int]] = []
        # (t, rows advanced, keys read a layer, adapter slots in use)
        self.gap_t: List[float] = []
        self.gap_s: List[float] = []
        self.admitted: List[Tuple[float, int]] = []       # (t, prompt len)
        self.train_log: Dict[str, List[TrainRecord]] = {}
        self.versions: Dict[Tuple[str, int], Any] = {}
        self.served: List[Served] = []
        self.rounds: Dict[str, int] = {}
        self.installs: Dict[int, List[Tuple[float, Any]]] = {}
        self._tree_of: Dict[int, Tuple[str, int]] = {}    # id(tree) -> version
        # id(row meta) -> [(tokens decoded, the version then installed)]
        self._cuts: Dict[int, List[Tuple[int, Any]]] = {}
        # id(row meta) -> (t, slot, greedy)
        self._admitted_at: Dict[int, tuple] = {}
        # (tenant, prompt + completion ids) -> the row's version segments
        self.segments: Dict[Tuple[str, tuple], Segments] = {}
        self.unmatched_rows = 0
        self._live: Dict[int, list] = {}
        self._cur = threading.local()
        # the stop: no engine step starts once `stopping` is set, so the
        # runtime's own stop (which waits 10 s for its threads) never lands
        # inside a long step of radix installs
        self.stopping = False
        self.in_step = False

    # -- helpers ------------------------------------------------------------
    def _range(self, name: str):
        if not self.trace:
            return nullcontext()
        return torch.profiler.record_function(f"rlbench::{name}")

    def install(self):
        rt, eng = self.rt, self.rt.cengine
        eng._ensure_built()
        self._wrap_step(eng)
        self._wrap_decode(eng)
        self._wrap_train(rt)
        self._wrap_requests(rt)
        self._wrap_completions(rt)
        self._wrap_installs(eng)
        if self.trace:
            for name in ("_radix_fill_rows", "_refill_free_slots"):
                self._wrap_range(eng, name, name.strip("_"))

    def _wrap_range(self, obj, attr, label):
        fn = getattr(obj, attr)

        def wrapped(*a, **k):
            with self._range(label):
                return fn(*a, **k)
        setattr(obj, attr, wrapped)

    # -- the rollout thread -------------------------------------------------
    def _wrap_step(self, eng):
        orig = eng.step
        stats = eng.stats

        def step():
            if self.stopping:
                return False
            self.in_step = True
            t0 = time.monotonic()
            n0 = stats.decode_steps
            try:
                with self._range("decode_step"):
                    out = orig()
            finally:
                self.in_step = False
            t1 = time.monotonic()
            if stats.decode_steps != n0:
                self.steps.append((t0, t1))
                self._gaps(eng, t1)
            return out
        eng.step = step

    def _gaps(self, eng, t: float):
        live = self._live
        seen = set()
        for r in eng._rows:
            if r is None:
                continue
            k = id(r)
            seen.add(k)
            n = len(r.gen)
            ent = live.get(k)
            if ent is None:
                live[k] = [r, n, t]
                self.admitted.append((t, r.prompt_len))
                self._admitted_at[id(r.meta)] = (t, r.req.adapter_index,
                                                 r.req.temperature == 0)
            elif n > ent[1]:
                self.gap_t.append(t)
                self.gap_s.append(t - ent[2])
                ent[1], ent[2] = n, t
        for k in [k for k in live if k not in seen]:
            r, n, t_prev = live.pop(k)
            if len(r.gen) > n:
                self.gap_t.append(t)
                self.gap_s.append(t - t_prev)

    def _wrap_decode(self, eng):
        orig = eng._step_fn
        N = eng.max_slots

        def step_fn(*args):
            adv = np.frombuffer(eng._mask_sig[:4 * N], dtype=np.int32)
            pos = np.asarray(eng._slot_pos, dtype=np.int64)
            live = adv > 0
            slots = {eng._rows[i].req.adapter_index
                     for i in np.nonzero(live)[0] if eng._rows[i] is not None}
            self.decodes.append((time.monotonic(), int(live.sum()),
                                 float((pos[live] + 1).sum()), len(slots)))
            self._cur.slots = len(slots)
            with self._range("decode_forward"):
                return orig(*args)
        eng._step_fn = step_fn

    def _wrap_requests(self, rt):
        orig = rt._build_requests
        G = self.traffic.mix["group_size"]

        def build(tids, order):
            reqs = orig(tids, order)
            if len(tids) != 1:
                raise RuntimeError("the continuous feed builds one tenant's "
                                   "round at a time")
            tid = tids[0]
            k = self.rounds.get(tid, 0)
            self.rounds[tid] = k + 1
            per = self.traffic.mix["groups_per_batch"]
            for j, r in enumerate(reqs):
                if j % G == 0 and self.traffic.is_greedy(k * per + j // G):
                    r.temperature = 0.0
            return reqs
        rt._build_requests = build

    def version(self, tid: str, v: int, tree):
        """Record a tenant's committed tree of version `v`."""
        self.versions[(tid, v)] = tree
        self._tree_of[id(tree)] = (tid, v)

    def _wrap_installs(self, eng):
        orig = eng.set_adapters

        def set_adapters(index, tree):
            t = time.monotonic()
            ver = self._tree_of.get(id(tree))
            for r in eng._rows:
                if r is not None and r.req.adapter_index == index:
                    self._cuts.setdefault(id(r.meta), []).append(
                        (len(r.gen), ver))
            self.installs.setdefault(index, []).append((t, ver))
            return orig(index, tree)
        eng.set_adapters = set_adapters

    def _finished(self, comp) -> None:
        """A finished row: the versions that decoded its tokens (for the
        reference's behaviour logprobs), and, unless it was queued across an
        install or its version is not known, the part one version served."""
        key = id(comp.meta)
        cuts = self._cuts.pop(key, [])
        got = self._admitted_at.pop(key, None)
        if got is None:
            return
        adm, slot, greedy = got
        held, queued = None, False
        for t, ver in self.installs.get(slot, []):
            if comp.submitted_at < t < adm:
                queued = True
            if t <= adm:
                held = ver
        segs = [(0, held[1] if held is not None
                 else int(comp.meta.get("version", 0)))]
        for n, ver in cuts:
            v = ver[1] if ver is not None else segs[-1][1] + 1
            if n <= segs[-1][0]:
                segs[-1] = (segs[-1][0], v)
            else:
                segs.append((n, v))
        self.segments[(comp.task_id, tuple(comp.tokens))] = segs
        n = len(comp.tokens) - comp.prompt_len
        if cuts:
            n = min(n, cuts[0][0])
        if queued or held is None or n <= 0:
            return
        self.served.append(Served(
            comp.task_id, held[1], greedy, comp.prompt_len,
            list(comp.tokens[:comp.prompt_len + n]),
            list(comp.gen_logprobs[:n]), comp.finished_at))

    def _wrap_completions(self, rt):
        orig = rt._handle_completion

        def handle(comp, rounds):
            if comp.finish_reason in ("budget", "eos", "capacity"):
                self._finished(comp)
            return orig(comp, rounds)
        rt._handle_completion = handle

    # -- the trainer thread ---------------------------------------------------
    def _wrap_train(self, rt):
        orig = rt._train_one
        spec = rt.mgr.spec_for(next(iter(rt.mgr.tasks)))
        step_fn = rt._train_step_for(spec)

        def step(base, adapters, opt, batch):
            with self._range("train_forward_backward"):
                out = step_fn(base, adapters, opt, batch)
            self._cur.metrics = out[2]
            return out
        rt._train_steps[spec.group_size] = step

        def train_one(tb, trained_version=None):
            tid = tb.task_id
            self._cur.metrics = None
            t0 = time.monotonic()
            with self._range("train_step"):
                orig(tb, trained_version)
            t1 = time.monotonic()
            lm = tb.meta["loss_mask"]
            lengths = [int(x) for x in tb.total_lens]
            ntok = int(sum(lm[j, p - 1:t - 1].sum() for j, (p, t) in
                           enumerate(zip(tb.prompt_lens, tb.total_lens))))
            with self.lock:
                self.commits.append(Commit(t0, t1, tid, ntok, lengths))
                self.first_commit.setdefault(tid, t1)
            st = rt.mgr.state(tid)
            self.version(tid, st.version, st.adapters)
            v0 = int(trained_version if trained_version is not None
                     else tb.version)
            segs = []
            for j, t in enumerate(lengths):
                got = self.segments.pop((tid, tuple(int(x) for x in tb.tokens[j, :t])),
                                        None)
                if got is None:
                    self.unmatched_rows += 1
                    got = [(0, v0)]
                segs.append(got)
            log = self.train_log.setdefault(tid, [])
            # what the check reads besides the batches: the first update's
            # optimizer moment and the third's adapters
            log.append(TrainRecord(
                tid, v0, tb.tokens.copy(), tb.prompt_lens.copy(),
                tb.total_lens.copy(), tb.rewards.copy(), lm.copy(), segs,
                self._cur.metrics,
                st.adapters if len(log) == 2 else None,
                {"m": st.opt_state["m"]} if not log else None))
        rt._train_one = train_one


class KernelProbes:
    """Traced runs: a profiler range around each kernel's entry point, where
    the program looks it up, and the bound time of each call from its
    shapes. ``token_logprob`` is read in its forward: its backward runs on
    autograd's device thread, whose ranges the profiler draws no device
    span for, so the ctypes-launched backward kernels cannot be matched."""

    def __init__(self, shape: ys.Shape, probes: Probes):
        self.shape = shape
        self.probes = probes
        self.bound = {"paged_gqa_decode": 0.0, "sgmv": 0.0,
                      "token_logprob": 0.0}
        self.on = False
        self._undo: List[Tuple[Any, str, Any]] = []

    def install(self):
        import repro_torch.kernels.ops as ops
        import repro_torch.models.attention as attn
        import repro_torch.models.common as common
        import repro_torch.rollout.engine as engine

        def patch(mod, name, make):
            fn = getattr(mod, name)
            self._undo.append((mod, name, fn))
            setattr(mod, name, make(fn))

        def paged(fn):
            def wrapped(q, kp, vp, tbl, pos, **kw):
                with torch.profiler.record_function("rlbench::paged_gqa_decode"):
                    return fn(q, kp, vp, tbl, pos, **kw)
            return wrapped

        def sgmv(fn):
            def wrapped(y, rows, a, b, table, scaling, **kw):
                if self.on:
                    n = rows.numel() // rows.shape[-1]
                    used = getattr(self.probes._cur, "slots", 1) \
                        if n == self.probes.rt.cengine.max_slots else 1
                    f, by = ys.sgmv_cost(n, a.shape[1], b.shape[2], a.shape[2],
                                         max(1, min(used, a.shape[0])))
                    self.bound["sgmv"] += ys.bound_s(f, by)
                with torch.profiler.record_function("rlbench::sgmv"):
                    return fn(y, rows, a, b, table, scaling, **kw)
            return wrapped

        def logprob(fn):
            def wrapped(hidden, vocab_w, targets, softcap=0.0):
                if self.on:
                    B, S, d = hidden.shape
                    f, by = ys.token_logprob_fwd_cost(B * S, d, vocab_w.shape[1])
                    self.bound["token_logprob"] += ys.bound_s(f, by)
                with torch.profiler.record_function("rlbench::token_logprob"):
                    return fn(hidden, vocab_w, targets, softcap)
            return wrapped

        def sample(fn):
            def wrapped(*a, **k):
                with torch.profiler.record_function("rlbench::sample_rows"):
                    return fn(*a, **k)
            return wrapped

        patch(attn, "paged_gqa_decode", paged)
        patch(common, "sgmv_add_", sgmv)
        patch(ops, "token_logprob", logprob)
        patch(engine, "_sample_rows", sample)
    def decode_bounds(self, t_open: float, t_close: float):
        """The paged kernel's bound over the window's decode steps: every
        layer reads each advanced row's keys once."""
        s = self.shape
        total = 0.0
        for t, rows, keys, _ in self.probes.decodes:
            if t_open <= t <= t_close:
                f, by = ys.paged_decode_cost(s, keys, rows)
                total += s.layers * ys.bound_s(f, by)
        self.bound["paged_gqa_decode"] = total

    def uninstall(self):
        for obj, name, fn in reversed(self._undo):
            setattr(obj, name, fn)
        self._undo.clear()


@dataclass
class RunState:
    """Everything a run leaves for the metric readers and the check."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    setup: Dict[str, float]
    t_open: float = 0.0
    t_close: float = 0.0
    check_wait_s: float = 0.0     # the runtime's run past the close
    counters_open: Dict[str, int] = field(default_factory=dict)
    counters_close: Dict[str, int] = field(default_factory=dict)
    probes: Optional[Probes] = None
    kprobes: Optional[KernelProbes] = None
    marks: Dict[int, List[Tuple[float, str]]] = field(default_factory=dict)
    device_trace: Optional[Dict[str, Any]] = None
    memory_peak_bytes: int = 0
    weights: Dict[str, torch.Tensor] = field(default_factory=dict)
    adapters0: List[Any] = field(default_factory=list)
    traffic: Optional[Traffic] = None
    lr: float = 3e-3
    notes: List[str] = field(default_factory=list)


def counters(eng) -> Dict[str, int]:
    return {k: int(getattr(eng.stats, k)) for k in COUNTERS}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        warmup_timeout_s: float = 600.0, log=print, fault=None) -> RunState:
    """One run of `cell`: set-up, warm-up, the window, the stop. Returns the
    state with the program's objects released (but for what the check
    needs). Where fewer than ``CHECK_TENANTS`` tenants have made
    ``CHECK_UPDATES`` updates when the window closes (a traced window, under
    the profiler, commits few), the runtime runs on past the close, for at
    most ``CHECK_WAIT_S``, until they have: no metric reads past the close.
    `fault`, when given, is called with the runtime before it starts: the
    tests break the timed path with it."""
    t_start = time.monotonic()
    # the program imports torch.distributed.tensor lazily from the trainer
    # thread while the rollout thread tests sys.modules for it
    # (kernels/boundary.is_dtensor): a half-imported module there raises.
    # Importing it before the threads start keeps that race out of the run.
    import torch.distributed.tensor  # noqa: F401
    from repro_torch.core.manager import TaskSpec
    from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
    dev = torch.device(device)
    cfg = cell.config
    mix = cell.traffic
    builder = cell.builder
    shape = builder.shape(cfg)
    t_import = time.monotonic()
    setup = {"imports_s": t_import - t_start}
    if dev.type == "cuda":
        from repro_torch.kernels._build import build_all
        build_all()
    t_kern = time.monotonic()
    setup["kernels_s"] = t_kern - t_import
    weights = builder.make_base(cfg, seed, dev)
    adapters0 = builder.make_adapters(cfg, mix["tenants"], seed, dev)
    traffic = Traffic(mix, seed, shape.vocab)
    pcfg = builder.port_config(cfg)
    page = cfg["kv_page_size"]
    slots = cfg["max_slots"]
    pool = int(traffic.pool_pages(page, slots) * 1.25)
    rt = MARLaaSRuntime(pcfg, builder.port_params(weights), RuntimeConfig(
        policy="marlaas", rollout_mode="continuous", max_slots=slots,
        max_adapter_slots=mix["tenants"], max_len=mix["max_len"],
        device=str(dev), seed=int(seed) % (2 ** 31), paged_kv=True,
        kv_page_size=page, kv_pool_pages=pool, prefix_cache=True,
        async_train=True, max_staleness=mix["max_staleness"],
        min_train_rows=mix["min_train_rows"], trace=trace))
    lr = 3e-3
    trees0 = [{"layers": a} for a in adapters0]
    for i in range(mix["tenants"]):
        rt.submit_task(TaskSpec(traffic.tid(i), "gsm8k",
                                group_size=mix["group_size"],
                                num_groups=mix["groups_per_batch"],
                                max_new_tokens=traffic.budget[i],
                                target_steps=10 ** 9, temperature=1.0, lr=lr),
                       trees0[i])
        rt.envs[traffic.tid(i)] = traffic.env(i)
        rt.datagens[traffic.tid(i)] = traffic.datagen(i)
    probes = Probes(rt, traffic, trace)
    probes.install()
    for i in range(mix["tenants"]):
        probes.version(traffic.tid(i), 0, trees0[i])
    kprobes = None
    if trace:
        kprobes = KernelProbes(shape, probes)
        kprobes.install()
    if fault is not None:
        fault(rt)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_load = time.monotonic()
    setup["load_s"] = t_load - t_kern
    errors: List[BaseException] = []

    def serve():
        try:
            rt.run(timeout_s=10 ** 7)
        except BaseException as e:      # surfaced to the caller below
            errors.append(e)
    th = threading.Thread(target=serve, name="rlbench-runtime", daemon=True)
    th.start()
    deadline = t_load + warmup_timeout_s
    while len(probes.first_commit) < mix["tenants"]:
        if errors or not th.is_alive():
            raise RuntimeError(f"the runtime stopped in warm-up: {errors}")
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"warm-up: {len(probes.first_commit)} of {mix['tenants']} "
                f"tenants committed in {warmup_timeout_s:.0f} s")
        time.sleep(0.05)
    t_warm = time.monotonic()
    setup["warmup_s"] = t_warm - t_load
    setup["setup_s"] = t_warm - t_start
    state = RunState(cell, seed, seconds, trace, device, setup,
                     traffic=traffic, lr=lr)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        try:        # ranges opened on the runtime's threads, not just this one
            from torch._C._profiler import _ExperimentalConfig
            exp = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            exp = None
        prof = profile(activities=acts, experimental_config=exp)
        prof.__enter__()
        kprobes.on = True
    state.counters_open = counters(rt.cengine)
    state.t_open = time.monotonic()
    time.sleep(seconds)
    state.t_close = time.monotonic()
    state.counters_close = counters(rt.cengine)
    if trace:
        kprobes.on = False
        prof.__exit__(None, None, None)
        kprobes.decode_bounds(state.t_open, state.t_close)
    t_wait = time.monotonic()
    while (sum(len(v) >= CHECK_UPDATES for v in probes.train_log.values())
           < min(CHECK_TENANTS, mix["tenants"])
           and time.monotonic() - t_wait < CHECK_WAIT_S
           and th.is_alive() and not errors):
        time.sleep(0.05)
    state.check_wait_s = time.monotonic() - t_wait
    probes.stopping = True
    t_stop = time.monotonic()
    while probes.in_step and time.monotonic() - t_stop < 300:
        time.sleep(0.01)
    rt._stop.set()
    th.join(timeout=120)
    if th.is_alive():
        raise RuntimeError("the runtime did not stop within 120 s")
    if errors:
        raise RuntimeError(f"the runtime failed: {errors[0]!r}") from errors[0]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        state.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    if trace:
        from .devtrace import reduce_profile
        state.device_trace = reduce_profile(prof, state.t_open, state.t_close)
        kprobes.uninstall()
        del prof
    if rt.tracer is not None:
        state.marks = rt.tracer.marks()
    if counters(rt.cengine)["pool_exhausted"]:
        state.notes.append("the page pool ran dry: rows ended by capacity")
    state.probes = probes
    state.kprobes = kprobes
    state.weights = weights
    state.adapters0 = adapters0
    # release the program: its engine, caches, trainer and manager
    probes.rt = None
    probes._live = {}
    rt.cengine.shutdown()
    del rt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[rlbench] setup {setup}")
    return state
