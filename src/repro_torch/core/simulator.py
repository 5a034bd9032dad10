"""Discrete-event simulator for MARLaaS scheduling at paper scale.

Runs the SAME MultiTaskManager + admission control as the real runtime, but
executes rollout/env/train phases in virtual time against a first-principles
hardware model, so paper Tables 2–4 and Figs 6–7 (0.6B/14B/32B × multi-NPU,
up to 32 tenants) are reproducible on a 1-core CPU box.

Hardware/latency model (documented in EXPERIMENTS.md §Benchmarks):
- decode is HBM-bound. The rollout pool steps its *fused* batch once per
  `(param_bytes + Σ_rows kv_bytes) / (pool_HBM_bw · eff)` seconds — weight
  reads are shared across all resident tenants, which is exactly the
  multi-LoRA batching advantage. Baselines WITHOUT multi-LoRA pay the
  weight read per task (no fusion possible).
- prefill/training are compute-bound: `2·N·tokens / (pool_peak · mfu)` and
  `6·N·tokens / (train_peak · mfu)`.
- environment interaction removes a job from the pool for a sampled latency
  (external tools/judge — consumes no accelerator).
- a single `calib` factor scales absolute rollout latency to the paper's
  measured Table 1 values (their Ascend stack ≠ the model's constants);
  relative behaviour across regimes comes from the model, not the knob.

A copy of ``repro.core.simulator`` with its imports pointed at the port.
One change: ``HardwareModel``'s default peaks are one H100 SXM's data
sheet (989e12 bf16 FLOP/s, 3.35e12 B/s of HBM; ``launch/roofline.py``'s
table), not the reference's accelerator's. Pass a ``HardwareModel`` to
model another device; nothing here was measured.

Event engine: heap of (virtual_time, seq, fn). Membership changes in the
decode set trigger rate recomputation (processor-sharing with shared
weight reads).
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.configs import ModelConfig
from .admission import AdmissionConfig, AdmissionController, task_state_bytes
from .manager import MultiTaskManager, TaskSpec
from .metrics import MetricsRecorder


@dataclass
class HardwareModel:
    n_devices: int = 16
    train_devices: int = 2          # paper §5: 0.6B→2, 14B→4, 32B→16
    peak_flops_per_dev: float = 989e12     # H100 SXM data sheet, bf16
    hbm_bw_per_dev: float = 3.35e12        # H100 SXM data sheet, HBM3
    mem_eff: float = 0.55
    prefill_mfu: float = 0.40
    train_mfu: float = 0.35
    train_overhead_s: float = 0.6   # commit/weight-sync/launch overhead
    step_overhead_s: float = 0.0    # fixed per-decode-step latency (engine
                                    # launch/RPC; dominates small-batch decode)
    calib: float = 1.0              # absolute-latency calibration (Table 1)

    @property
    def rollout_devices(self) -> int:
        return self.n_devices - self.train_devices


@dataclass
class WorkloadModel:
    """Per-task rollout/train cost profile derived from env + model cfg."""
    prompt_len: int
    gen_len: int                    # decode tokens per row
    rows: int                       # batch rows per rollout
    n_tool_calls: int = 0
    env_latency_mean: float = 0.0
    env_latency_std: float = 0.0

    @property
    def tokens_per_batch(self) -> int:
        return self.rows * (self.prompt_len + self.gen_len)


# paper §5 workload definitions (max gen length × batch size)
PAPER_WORKLOADS = {
    "gsm8k": WorkloadModel(prompt_len=128, gen_len=2048, rows=64),
    "amc12": WorkloadModel(prompt_len=192, gen_len=4096, rows=32),
    "search": WorkloadModel(prompt_len=256, gen_len=1024, rows=32,
                            n_tool_calls=3, env_latency_mean=6.0,
                            env_latency_std=2.0),
}


class SimClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@dataclass
class _DecodeJob:
    task_id: str
    version: int
    rows: int
    kv_bytes: float
    segments: List[Tuple[str, float]]     # ("decode", tokens) | ("env", s)
    seg_idx: int = 0
    tokens_left: float = 0.0
    entered_pool_at: float = 0.0
    on_done: Optional[Callable] = None
    multi_lora: bool = True
    trace: Optional[int] = None     # repro_torch.obs trace id (tracing enabled)
    flow_in: int = 0                # pending hand-off arrow (resume→pool)


class Simulator:
    """Virtual-time executor; policies drive it via schedule()/callbacks."""

    def __init__(self, cfg: ModelConfig, hw: HardwareModel, seed: int = 0,
                 trace: bool = False):
        self.cfg = cfg
        self.hw = hw
        self.clock = SimClock()
        self.heap: List[Tuple[float, int, Callable]] = []
        self._seq = itertools.count()
        self.rng = random.Random(seed)
        self.rec = MetricsRecorder({"rollout": hw.rollout_devices,
                                    "train": hw.train_devices})
        # virtual-time episode tracing: the tracer reads the SIM
        # clock, so sim traces share the threaded runtime's span structure
        # (same canonical states, same park/resume flow arrows) with
        # virtual timestamps — the parity property tests pin this
        self.tracer = None
        if trace:
            from repro_torch.obs import Tracer
            self.tracer = Tracer(clock=self.clock)
        self.param_bytes = cfg.param_count() * 2
        # decode pool state
        self.decode_set: Dict[str, _DecodeJob] = {}
        self._decode_wait: List[_DecodeJob] = []   # exclusive-job FIFO
        self._decode_rate_t0 = 0.0
        self._decode_step_s = None
        self._decode_event_seq = 0
        # train engine
        self.train_busy_until = 0.0

    # -- event engine -----------------------------------------------------
    def schedule(self, delay: float, fn: Callable):
        heapq.heappush(self.heap, (self.clock.t + max(0.0, delay),
                                   next(self._seq), fn))

    def run(self, until: float = float("inf"), stop: Callable[[], bool] = None):
        while self.heap:
            t, _, fn = heapq.heappop(self.heap)
            if t > until:
                break
            self._advance_decode(t)
            self.clock.t = t
            fn()
            if stop is not None and stop():
                break

    # -- decode pool: fused token stepping --------------------------------
    def _pool_bw(self) -> float:
        return self.hw.rollout_devices * self.hw.hbm_bw_per_dev * self.hw.mem_eff

    def _step_seconds(self) -> Optional[float]:
        """Seconds per one fused decode step for the current resident set."""
        if not self.decode_set:
            return None
        jobs = self.decode_set.values()
        if all(j.multi_lora for j in jobs):
            weight_reads = 1
        else:
            weight_reads = len(self.decode_set)   # no fusion: per-task read
        bytes_per_step = (weight_reads * self.param_bytes
                          + sum(j.kv_bytes for j in jobs))
        # decode steps are latency-bound until the fused batch saturates HBM
        # bandwidth — the regime boundary that makes multi-LoRA batching
        # nearly free at low concurrency (paper Fig 6 knee).
        return max(self.hw.step_overhead_s,
                   self.hw.calib * bytes_per_step / self._pool_bw())

    def _advance_decode(self, t_now: float):
        """Progress all resident decode jobs from the last rate change."""
        if self._decode_step_s is None or not self.decode_set:
            self._decode_rate_t0 = t_now
            return
        dt = t_now - self._decode_rate_t0
        if dt <= 0:
            return
        toks = dt / self._decode_step_s
        for j in self.decode_set.values():
            j.tokens_left = max(0.0, j.tokens_left - toks)
        if self.decode_set:
            self.rec.record("rollout", "decode", "+".join(self.decode_set),
                            self._decode_rate_t0, t_now,
                            self.hw.rollout_devices)
        self._decode_rate_t0 = t_now

    def _reschedule_decode(self):
        """Recompute fused step time; schedule next earliest completion."""
        self._decode_step_s = self._step_seconds()
        self._decode_rate_t0 = self.clock.t
        if not self.decode_set:
            return
        nxt = min(j.tokens_left for j in self.decode_set.values())
        self._decode_event_seq += 1
        seq = self._decode_event_seq
        eta = nxt * self._decode_step_s

        def fire(seq=seq):
            if seq != self._decode_event_seq:
                return        # superseded by a membership change
            self._on_decode_tick()

        self.schedule(eta, fire)

    def _on_decode_tick(self):
        finished = [j for j in self.decode_set.values() if j.tokens_left <= 1e-9]
        for j in finished:
            del self.decode_set[j.task_id]
            self._job_segment_done(j)
        while self._decode_wait and not self.decode_set:
            nxt = self._decode_wait.pop(0)
            self.decode_set[nxt.task_id] = nxt
            self._tr_pool_enter(nxt)
            if nxt.multi_lora:      # fused jobs can co-admit queued peers
                while self._decode_wait and self._decode_wait[0].multi_lora:
                    p = self._decode_wait.pop(0)
                    self.decode_set[p.task_id] = p
                    self._tr_pool_enter(p)
            break
        self._reschedule_decode()

    # -- tracing hooks (virtual-time mirror of the engine's span model) ----
    def _tr_pool_enter(self, j: _DecodeJob):
        """Job joins the decode pool: open its residency span."""
        if self.tracer is None or j.trace is None:
            return
        j.entered_pool_at = self.clock.t
        self.tracer.mark(j.trace, "decode", self.clock.t)

    def _tr_pool_exit(self, j: _DecodeJob, flow_out: int = 0):
        """Close the residency span (park hand-off or completion)."""
        if self.tracer is None or j.trace is None:
            return
        self.tracer.span(("rollout", "pool"), j.task_id,
                         j.entered_pool_at, self.clock.t, trace=j.trace,
                         flow_in=j.flow_in, flow_out=flow_out)
        j.flow_in = 0

    def _job_segment_done(self, j: _DecodeJob):
        tr = self.tracer if j.trace is not None else None
        j.seg_idx += 1
        if j.seg_idx >= len(j.segments):
            if tr is not None:      # final segment is always decode
                self._tr_pool_exit(j)
                tr.mark(j.trace, "completed", self.clock.t)
            if j.on_done:
                j.on_done()
            return
        kind, amount = j.segments[j.seg_idx]
        if kind == "env":
            # park: the job leaves the pool for the env interaction and
            # resumes via a (virtual, zero-duration) replay prefill — the
            # SAME canonical state sequence and park/resume flow arrows the
            # threaded engine emits, with the sim's instantaneous analogs
            if tr is not None:
                fid = tr.next_flow("park")
                self._tr_pool_exit(j, flow_out=fid)
                tr.mark(j.trace, "parked", self.clock.t)
                tr.mark(j.trace, "env", self.clock.t)
                rfid = tr.next_flow("resume")
                tr.span(("env", "pool"), j.task_id, self.clock.t,
                        self.clock.t + amount, trace=j.trace,
                        flow_in=fid, flow_out=rfid)
                j.flow_in = rfid
            self.rec.record("env", "env", j.task_id, self.clock.t,
                            self.clock.t + amount, 0)

            # after the external wait, advance to the next (decode) segment
            def resume():
                if tr is not None:
                    tr.mark(j.trace, "resume_queued", self.clock.t)
                    tr.mark(j.trace, "prefill", self.clock.t)
                self._job_segment_done(j)

            self.schedule(amount, resume)
        else:
            j.tokens_left = amount
            self._job_enter_pool(j)

    def _job_enter_pool(self, j: _DecodeJob):
        # without multi-LoRA fusion the engine serves ONE adapter at a time
        # (paper Table 4 "w/o multi-LoRA"): jobs queue for exclusive access
        if not j.multi_lora and self.decode_set:
            self._decode_wait.append(j)
            return
        if j.multi_lora and self.decode_set and not all(
                x.multi_lora for x in self.decode_set.values()):
            self._decode_wait.append(j)
            return
        self._advance_decode(self.clock.t)
        self.decode_set[j.task_id] = j
        self._tr_pool_enter(j)
        self._reschedule_decode()

    # -- public phase API used by policies ---------------------------------
    def submit_rollout(self, spec: TaskSpec, wl: WorkloadModel, version: int,
                       on_done: Callable, *, multi_lora: bool = True,
                       pool_devices: Optional[int] = None):
        """Prefill (compute-bound, brief) then fused decode (+env phases)."""
        devs = pool_devices or self.hw.rollout_devices
        N = self.cfg.active_param_count()
        prefill_s = (self.hw.calib * 2 * N * wl.prompt_len * wl.rows
                     / (devs * self.hw.peak_flops_per_dev * self.hw.prefill_mfu))
        kv_per_row = (self.cfg.state_bytes_per_token(2)
                      * (wl.prompt_len + 0.5 * wl.gen_len)
                      + self.cfg.state_bytes_fixed(2))
        segments: List[Tuple[str, float]] = []
        if wl.n_tool_calls:
            per = wl.gen_len / (wl.n_tool_calls + 1)
            for i in range(wl.n_tool_calls):
                segments.append(("decode", per))
                lat = max(0.1, self.rng.gauss(wl.env_latency_mean,
                                              wl.env_latency_std))
                segments.append(("env", lat))
            segments.append(("decode", per))
        else:
            segments.append(("decode", float(wl.gen_len)))
        job = _DecodeJob(task_id=spec.task_id, version=version, rows=wl.rows,
                         kv_bytes=kv_per_row * wl.rows, segments=segments,
                         tokens_left=segments[0][1], on_done=on_done,
                         multi_lora=multi_lora)
        t0 = self.clock.t
        if self.tracer is not None:
            # one trace per sim job (the sim's episode granularity): queued
            # and prefill are instantaneous-start in virtual time
            job.trace = self.tracer.new_trace(spec.task_id)
            self.tracer.mark(job.trace, "queued", t0)
            self.tracer.mark(job.trace, "prefill", t0)
            self.tracer.span(("prefill", "pool"), spec.task_id, t0,
                             t0 + prefill_s, trace=job.trace)
        self.rec.record("rollout", "prefill", spec.task_id, t0, t0 + prefill_s,
                        devs)

        def start():
            self._job_enter_pool(job)

        self.schedule(prefill_s, start)
        return job

    def submit_train(self, spec: TaskSpec, wl: WorkloadModel, version: int,
                     on_done: Callable, *, pool_devices: Optional[int] = None,
                     trace_ids: Tuple[int, ...] = ()):
        """Serialized train engine (paper §4.5)."""
        devs = pool_devices or self.hw.train_devices
        N = self.cfg.active_param_count()
        tokens = wl.tokens_per_batch
        dur = (self.hw.calib * 6 * N * tokens
               / (devs * self.hw.peak_flops_per_dev * self.hw.train_mfu)
               + self.hw.train_overhead_s)
        start_t = max(self.clock.t, self.train_busy_until)
        self.train_busy_until = start_t + dur
        if self.tracer is not None and trace_ids:
            self.tracer.span(("train", "pool"), spec.task_id, start_t,
                             start_t + dur)
            for tr in trace_ids:
                self.tracer.mark(tr, "train", start_t)
                self.tracer.mark(tr, "committed", start_t + dur)
        self.rec.record("train", "train", spec.task_id, start_t, start_t + dur,
                        devs)
        self.schedule(start_t + dur - self.clock.t, on_done)
        return dur
