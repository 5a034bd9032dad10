"""The port's copies of the discrete-event simulator and the scheduling
policies (``repro_torch.core.{simulator,policies}``), and of the 13
per-arch config modules (``repro_torch.configs.<arch>``), against the JAX
package's.

- ``run_sim`` for every policy and every call of ``tests/test_sim.py``
  (its ``_run`` settings: 3 tasks x 3 steps, 6 x 5, 1/4/16 tenants of
  marlaas, the tight and loose KV budgets; its ``PAPER_WORKLOADS`` cell,
  "search") in both packages, on the same hardware model: equal
  ``summarize`` metrics (plain Python: exactly equal), and the decode-rate
  model of ``test_multi_lora_weight_sharing_matters``.
- The simulator's traces on both packages: the same canonical state
  sequences, flow kinds and component times for 0-2 tool calls
  (``tests/test_obs.py:263``'s structure check; the port's threaded engine
  against the port's simulator is in ``tests/test_torch_obs.py``).
- Every ``PAPER_WORKLOADS`` cell: the same profile and the same metrics
  of marlaas over two tenants.
- Each config module's ``CONFIG``, ``SMOKE`` and ``SHAPES`` equal the
  reference's, field by field (one case an arch)."""
import dataclasses
import importlib

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as r_get_config
from repro.core import admission as r_adm
from repro.core import manager as r_mgr
from repro.core import metrics as r_met
from repro.core import policies as r_pol
from repro.core import simulator as r_sim
from repro_torch.configs import get_config as p_get_config
from repro_torch.core import admission as p_adm
from repro_torch.core import manager as p_mgr
from repro_torch.core import metrics as p_met
from repro_torch.core import policies as p_pol
from repro_torch.core import simulator as p_sim

PKGS = {"ref": (r_get_config, r_adm, r_mgr, r_met, r_pol, r_sim),
        "port": (p_get_config, p_adm, p_mgr, p_met, p_pol, p_sim)}

# the JAX package's default hardware model, handed to both packages: the
# port's own defaults are the H100's data sheet
HW = dataclasses.asdict(r_sim.HardwareModel(n_devices=16, train_devices=2))

# (policy or None for all, n_tasks, steps, budget): tests/test_sim.py's runs
RUNS = ([(None, 3, 3, 200e9), (None, 6, 5, 200e9)]
        + [("marlaas", n, 5, 200e9) for n in (1, 4, 16)]
        + [("marlaas", 8, 5, b) for b in (2e9, 400e9)])
CASES = [(pol, n, s, b) for (p, n, s, b) in RUNS
         for pol in ([p] if p else sorted(r_pol.POLICIES))]


def _run(pkg, policy, n_tasks, steps, budget, env="search"):
    get_config, adm, mgr, met, pol, sim = PKGS[pkg]
    specs = [mgr.TaskSpec(f"{env}-{i}", env, target_steps=steps)
             for i in range(n_tasks)]
    wls = {s.task_id: sim.PAPER_WORKLOADS[env] for s in specs}
    m, rec = pol.run_sim(policy, get_config("qwen3-0.6b"),
                         sim.HardwareModel(**HW), specs, wls,
                         adm.AdmissionConfig(memory_budget_bytes=budget))
    return met.summarize(m, rec)


def test_the_same_policies():
    assert sorted(p_pol.POLICIES) == sorted(r_pol.POLICIES)


@pytest.mark.parametrize("policy,n_tasks,steps,budget", CASES)
def test_run_sim_equals_reference(policy, n_tasks, steps, budget):
    want = _run("ref", policy, n_tasks, steps, budget)
    have = _run("port", policy, n_tasks, steps, budget)
    assert have == want
    assert have["total_steps"] == n_tasks * steps


def test_the_qualitative_claims_hold_in_the_port():
    """tests/test_sim.py's orderings, on the port's runs."""
    res = {pol: _run("port", pol, 6, 5, 200e9) for pol in p_pol.POLICIES}
    best = res["marlaas"]
    for other in ("multilora_sync", "single_colloc", "single_disagg"):
        assert best["steps_per_hr"] > res[other]["steps_per_hr"]
    assert best["utilization_pct"] == max(r["utilization_pct"]
                                          for r in res.values())
    assert res["single_disagg"]["ttfs_mean_s"] > best["ttfs_mean_s"]


def test_multi_lora_step_seconds_equal_reference():
    out = {}
    for pkg in PKGS:
        get_config, *_, sim = PKGS[pkg]
        s = sim.Simulator(get_config("qwen3-0.6b"), sim.HardwareModel(**HW))
        jobs = [sim._DecodeJob(f"t{i}", 0, 8, 1e9, [("decode", 100.0)],
                               tokens_left=100.0, multi_lora=True)
                for i in range(4)]
        for j in jobs:
            s.decode_set[j.task_id] = j
        fused = s._step_seconds()
        for j in s.decode_set.values():
            j.multi_lora = False
        out[pkg] = (fused, s._step_seconds())
    assert out["port"] == out["ref"]
    assert out["port"][1] > out["port"][0] * 1.5


def test_hardware_defaults_are_the_h100_data_sheet():
    hw = p_sim.HardwareModel()
    assert (hw.peak_flops_per_dev, hw.hbm_bw_per_dev) == (989e12, 3.35e12)
    assert set(dataclasses.asdict(hw)) == set(HW)


@pytest.mark.parametrize("env", sorted(r_sim.PAPER_WORKLOADS))
def test_paper_workloads_equal_reference(env):
    """Every PAPER_WORKLOADS cell: the same profile, and marlaas over two
    tenants of it gives the same metrics."""
    a, b = r_sim.PAPER_WORKLOADS[env], p_sim.PAPER_WORKLOADS[env]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (_run("port", "marlaas", 2, 2, 200e9, env=env)
            == _run("ref", "marlaas", 2, 2, 200e9, env=env))


def _sim_trace(pkg, n_calls):
    get_config, adm, mgr, met, pol, sim = PKGS[pkg]
    s = sim.Simulator(get_config("qwen3-0.6b"), sim.HardwareModel(**HW),
                      trace=True)
    wl = sim.WorkloadModel(prompt_len=64, gen_len=128, rows=4,
                           n_tool_calls=n_calls, env_latency_mean=3.0)
    done = []
    s.submit_rollout(mgr.TaskSpec("hop", "search"), wl, 0,
                     on_done=lambda: done.append(1))
    s.run()
    assert done
    tr = s.tracer
    comps = tr.components()
    return [(tr.state_sequence(t), tr.flow_kinds_of(t),
             comps[t]["components"], comps[t]["t1"] - comps[t]["t0"])
            for t in sorted(comps)]


@pytest.mark.parametrize("n_calls", [0, 1, 2])
def test_sim_traces_equal_reference(n_calls):
    """The span structure of tests/test_obs.py:263 on the port's simulator:
    per episode, the state sequence (a park is followed by env and
    resume_queued), the flow kinds (park, resume per call), and components
    that partition the virtual end-to-end time, all equal to the JAX
    simulator's."""
    want, have = _sim_trace("ref", n_calls), _sim_trace("port", n_calls)
    assert have == want
    for seq, flows, comps, e2e in have:
        for i, st in enumerate(seq):
            if st == "parked":
                assert seq[i + 1] == "env" and seq[i + 2] == "resume_queued"
        assert flows == ["park", "resume"] * n_calls
        assert sum(comps.values()) == pytest.approx(e2e)


ARCH_MODULES = ["chameleon_34b", "dbrx_132b", "deepseek_moe_16b",
                "gemma2_27b", "granite_3_2b", "mamba2_780m",
                "nemotron_4_340b", "qwen1_5_110b", "qwen3_0_6b", "qwen3_14b",
                "qwen3_32b", "seamless_m4t_large_v2", "zamba2_1_2b"]


def _plain(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("name", ARCH_MODULES)
def test_config_module_equals_reference(name):
    ref = importlib.import_module(f"repro.configs.{name}")
    port = importlib.import_module(f"repro_torch.configs.{name}")
    assert _plain(port.CONFIG) == _plain(ref.CONFIG)
    assert _plain(port.SMOKE) == _plain(ref.SMOKE)
    assert [_plain(s) for s in port.SHAPES] == [_plain(s) for s in ref.SHAPES]
    assert port.CONFIG == p_get_config(ref.CONFIG.name)


def test_every_reference_config_module_has_a_copy():
    import pkgutil

    import repro.configs
    mods = {m.name for m in pkgutil.iter_modules(repro.configs.__path__)}
    assert sorted(mods - {"archs", "base"}) == ARCH_MODULES
