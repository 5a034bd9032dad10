"""The metric arithmetic against hand counts."""
from types import SimpleNamespace as NS

import numpy as np
import pytest

from rlbench import run as R
from rlbench.harness import devtrace
from rlbench.harness import yardstick as ys
from rlbench.harness.driver import Commit

SHAPE = ys.Shape(layers=2, d=8, heads=2, kv_heads=1, head_dim=4, ff=16,
                 vocab=32, lora_rank=2, lora_targets=("attn_q", "mlp_out"))


def state(**kw):
    probes = NS(commits=kw.pop("commits", []), gap_t=kw.pop("gap_t", []),
                gap_s=kw.pop("gap_s", []), steps=kw.pop("steps", []),
                decodes=kw.pop("decodes", []), admitted=kw.pop("admitted", []))
    base = dict(t_open=10.0, t_close=20.0, probes=probes, marks={},
                device_trace=None, kprobes=None, setup={"setup_s": 5.0},
                counters_open={"decode_steps": 0, "sampled_tokens": 0,
                               "prefill_tokens": 0, "prefix_hit_tokens": 0},
                counters_close={"decode_steps": 40, "sampled_tokens": 400,
                                "prefill_tokens": 30, "prefix_hit_tokens": 90},
                cell=NS(shape=SHAPE))
    base.update(kw)
    return NS(**base)


def c(t0, t1, tok, lengths=(10,)):
    return Commit(t0, t1, "t00", tok, list(lengths))


def test_trained_tokens_from_commit_to_commit():
    st = state(commits=[c(8, 9, 1000), c(10, 11, 100), c(12, 13, 200),
                        c(14, 15, 300), c(20, 21, 5000)])
    # commits at 11, 13, 15 lie in the window: (200 + 300) / (15 - 11)
    assert R.reader("trained_tok_s")(st) == pytest.approx(125.0)
    assert R.reader("trained_tok_s")(state(commits=[c(10, 11, 5)])) is None


def test_token_gap_p95_over_every_gap_in_the_window():
    gaps = list(np.linspace(0.001, 0.1, 100))
    st = state(gap_t=[15.0] * 100 + [25.0], gap_s=gaps + [9.0])
    want = 1000 * np.percentile(gaps, 95)
    assert R.reader("token_gap_p95_ms")(st) == pytest.approx(want)


def test_counters_over_the_window():
    st = state()
    assert R.reader("rollout_tok_s")(st) == pytest.approx(40.0)
    assert R.reader("decode_step_ms")(st) == pytest.approx(250.0)
    assert R.reader("prefix_hit_pct")(st) == pytest.approx(75.0)
    assert R.reader("setup_s")(st) == 5.0


def test_train_step_and_interference():
    st = state(commits=[c(11, 12, 1), c(14, 16, 1)],
               steps=[(10.5, 10.6), (11.5, 11.9), (13.0, 13.1), (15.0, 15.8),
                      (17.0, 17.1)])
    assert R.reader("train_step_ms")(st) == pytest.approx(1500.0)
    # inside: 0.4 and 0.8 s; outside: 0.1, 0.1, 0.1 s
    assert R.reader("train_interference_x")(st) == pytest.approx(6.0)


def test_episode_p90_over_rows_committed_in_the_window():
    marks = {i: [(1.0, "submitted"), (11.0 + i, "committed")] for i in range(10)}
    marks[99] = [(1.0, "submitted"), (30.0, "committed")]
    want = np.percentile([10.0 + i for i in range(10)], 90)
    assert R.reader("episode_p90_s")(state(marks=marks)) == pytest.approx(want)


def test_flops_by_hand():
    s = SHAPE
    layer = 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16)
    assert ys.fwd_flops_per_token(s, 0) == 2 * layer + 2 * 8 * 32
    assert ys.fwd_flops_per_token(s, 5) - ys.fwd_flops_per_token(s, 0) == \
        2 * 4 * 5 * 2 * 4
    lora = 2 * (2 * 2 * (8 + 8) + 2 * 2 * (16 + 8))
    assert ys.lora_flops_per_token(s) == lora
    # a sequence: every position at its own context
    by_pos = sum(ys.fwd_flops_per_token(s, p + 1) + lora for p in range(3, 9))
    assert ys.seq_flops(s, 3, 9) == pytest.approx(by_pos)
    assert ys.train_flops(s, [9]) == pytest.approx(
        2 * ys.seq_flops(s, 0, 9) + 9 * lora)
    assert ys.decode_flops(s, 2, 7.0) == pytest.approx(
        ys.fwd_flops_per_token(s, 3) + ys.fwd_flops_per_token(s, 4) + 2 * lora)


def test_mfu_by_hand():
    st = state(decodes=[(15.0, 2, 7.0, 1), (25.0, 9, 9.0, 1)],
               commits=[c(11, 12, 1, [9])], admitted=[(12.0, 6), (13.0, 6)],
               counters_close={"decode_steps": 40, "sampled_tokens": 400,
                               "prefill_tokens": 6, "prefix_hit_tokens": 6})
    want = (ys.decode_flops(SHAPE, 2, 7.0) + ys.train_flops(SHAPE, [9])
            + 2 * ys.seq_flops(SHAPE, 3, 6))
    got = R.reader("mfu")(st)
    assert got == pytest.approx(100 * want / (10.0 * ys.PEAK_FLOPS_BF16))


def test_kernel_costs_by_hand():
    f, b = ys.paged_decode_cost(SHAPE, keys=10, rows=2)
    assert f == 4 * 10 * 2 * 4
    assert b == 2 * 10 * 1 * 4 * 2 + 2 * 2 * 2 * 4 * 2
    f, b = ys.sgmv_cost(rows=3, d_in=8, d_out=16, rank=2, slots_used=2)
    assert f == 2 * 3 * 2 * 24 + 3 * 16
    assert b == 3 * 8 * 2 + 2 * 3 * 16 * 2 + 2 * 2 * 24 * 4
    f, b = ys.token_logprob_fwd_cost(5, 8, 32)
    assert f == 2 * 5 * 8 * 32 and b == 5 * 8 * 2 + 8 * 32 * 2 + 5 * 4 + 3 * 5 * 4
    assert ys.bound_s(989e12, 0) == pytest.approx(1.0)
    assert ys.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_roofline_share():
    st = state(device_trace={"range_s": {"sgmv": 2.0}, "busy_s": 2.5,
                             "window_s": 10.0},
               kprobes=NS(bound={"sgmv": 0.5}))
    assert R.reader("sgmv_roofline")(st) == pytest.approx(25.0)
    assert R.reader("device_idle_pct")(st) == pytest.approx(75.0)
    assert R.reader("paged_gqa_decode_roofline")(st) is None


class Ev:
    def __init__(self, name, dev, start, dur, corr, linked=0, tid=1, ann=False):
        self._v = (name, dev, start, dur, corr, linked, tid, ann)

    def name(self): return self._v[0]
    def device_type(self): return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def start_thread_id(self): return self._v[6]
    def is_user_annotation(self): return self._v[7]


def test_device_trace_reduction_by_hand():
    ev = [
        # thread 1: a decode step holding a sampler range and an aten op
        Ev("rlbench::decode_step", 0, 0, 100, 1, tid=1),
        Ev("rlbench::sample_rows", 0, 10, 20, 2, tid=1),
        Ev("aten::softmax", 0, 12, 5, 3, tid=1),
        Ev("cudaLaunchKernel", 0, 13, 1, 501, tid=7001),
        Ev("softmax_kernel", 1, 200, 50, 501, linked=3),
        # a ctypes launch inside an sgmv range: no linked operation
        Ev("rlbench::sgmv", 0, 40, 10, 4, tid=1),
        Ev("cudaLaunchKernelExC", 0, 41, 1, 502, tid=7001),
        Ev("sgmv_kernel", 1, 260, 30, 502, linked=0),
        # thread 2: the trainer, a kernel outside every range
        Ev("aten::mm", 0, 45, 5, 5, tid=2),
        Ev("cudaLaunchKernel", 0, 46, 1, 503, tid=7002),
        Ev("gemm", 1, 400, 100, 503, linked=5),
        # the device-side spans the profiler draws for the ranges
        Ev("rlbench::sgmv", 1, 260, 30, 9, ann=True),
        Ev("rlbench::decode_step", 1, 200, 90, 10, ann=True),
    ]
    out = devtrace.reduce_events(ev, window_s=1e-6)
    assert out["busy_s"] == pytest.approx(180e-9)
    assert out["range_s"]["sample_rows"] == pytest.approx(50e-9)
    assert out["range_s"]["sgmv"] == pytest.approx(30e-9)
    assert out["range_s"]["decode_step"] == pytest.approx(80e-9)
    assert out["attributed"] == 3 and out["linked"] == 2
    assert dict(out["device_ops"])["gemm"] == pytest.approx(100e-9)
    # gaps: 250..260 (host in no step at 255) and 290..400 (at 345: none)
    assert dict(out["idle_gaps"]) == {"none": pytest.approx(120e-9)}
