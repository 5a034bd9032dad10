"""The comparison that decides ``correct`` fails what it has to: a run of
the tiny cell on the CPU (fp32, the harness's look for a card skipped) is
correct as it stands, and not correct with the timed path broken
underneath, or with the control (the reference in fp8) in the program's
place."""
import pytest
import torch

from rlbench import calibrate
from rlbench.harness import correct, driver, measure

SEED = 2 ** 33 + 5


def _run(cell, fault=None):
    st = driver.run(cell, SEED, 3.0, False, "cpu", fault=fault,
                    log=lambda m: None)
    return st, correct.check(st, cell.limits, log=lambda m: None)


def _wrap_step(rt, make):
    spec = rt.mgr.spec_for(next(iter(rt.mgr.tasks)))
    inner = rt._train_steps[spec.group_size]
    rt._train_steps[spec.group_size] = make(inner)


def unchanged_state(rt):
    """A step that returns its state unchanged."""
    def make(inner):
        def step(base, adapters, opt, batch):
            return (adapters, opt, inner(base, adapters, opt, batch)[2])
        return step
    _wrap_step(rt, make)


def half_batch(rt):
    """Half of the batch left out, the mean taken over the rest."""
    def make(inner):
        def step(base, adapters, opt, batch):
            mask = batch["loss_mask"].clone()
            mask[mask.shape[0] // 2:] = 0
            return inner(base, adapters, opt, dict(batch, loss_mask=mask))
        return step
    _wrap_step(rt, make)


def altered_token(rt):
    """Every token altered where the decode step produces it."""
    eng = rt.cengine
    inner = eng._step_fn
    V = rt.cfg.vocab_size

    def step_fn(*args):
        nxt, lp, cache, counters = inner(*args)
        return (nxt + 1) % V, lp, cache, counters
    eng._step_fn = step_fn


def test_sound_run_is_correct(tiny_cell):
    st, (ok, readings, why) = _run(tiny_cell)
    assert ok, why
    assert readings["served_rows"] >= 2 and readings["leaves"] > 0
    for k in ("greedy_gap", "logprob_gap", "grad_gap", "update_gap", "loss_gap"):
        assert readings[k] < 1e-4, (k, readings[k])


@pytest.mark.parametrize("fault,number", [(unchanged_state, "update_gap"),
                                          (half_batch, "grad_gap"),
                                          (altered_token, "logprob_gap")])
def test_broken_timed_path_is_not_correct(tiny_cell, fault, number):
    st, (ok, readings, why) = _run(tiny_cell, fault)
    assert not ok
    assert readings[number] > 100 * tiny_cell.limits[number]["limit"], readings


def test_control_is_not_correct(tiny_cell):
    st, _ = _run(tiny_cell)
    prog, ctrl, half = calibrate.readings(st)
    over = [k for k, v in tiny_cell.limits.items() if ctrl.get(k, 0) > v["limit"]]
    assert over, ctrl
    assert half["grad_gap"] > 10 * prog["grad_gap"]
    torch.testing.assert_close(torch.tensor(prog["logprob_gap"]),
                               torch.tensor(0.0), atol=1e-4, rtol=0)


def test_a_window_short_of_updates_runs_on_until_the_check_has_them(tiny_cell):
    """A window that closes before two tenants made three updates (as a
    traced one can) leaves the runtime running past the close until they
    have; the window's metrics stop at the close."""
    st = driver.run(tiny_cell, SEED + 1, 0.05, False, "cpu", log=lambda m: None)
    ok, readings, why = correct.check(st, tiny_cell.limits, log=lambda m: None)
    assert ok, why
    assert st.check_wait_s > 0
    assert sum(len(v) >= driver.CHECK_UPDATES
               for v in st.probes.train_log.values()) >= driver.CHECK_TENANTS
    assert any(c.t1 > st.t_close for c in st.probes.commits)
    assert all(st.t_open <= c.t1 <= st.t_close
               for c in measure.window_commits(st))
