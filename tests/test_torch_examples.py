"""The four entry points of ``repro_torch.launch`` that stand for the JAX
package's examples (``examples/{quickstart,serve_multi_lora,failover_demo,
rl_learning_demo}.py``), on the CPU.

Each entry point's body takes its weights, so the JAX example's own
weights (``repro.models.init_params`` and ``repro.lora.adapters.init_lora``
on the example's keys) go through ``repro_torch.bridge`` into it, while the
JAX example itself runs unchanged (``runpy``), its results read where it
makes them (its engine's ``generate`` and its jitted train step):
- serve_multi_lora: the port's token streams equal the example's (the
  sampler is bit-exact);
- quickstart, 2 steps: per-step reward equal, loss and entropy within
  1e-5 of the example's;
- failover_demo: the crash and restart happen and the row account
  balances; rl_learning_demo (cut to 3 SFT steps and 2 rounds) and every
  entry point's CLI on the CPU end with their kernels' launch line."""
import dataclasses
import io
import json
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.rollout.engine as j_engine
from repro.configs import REGISTRY as J_REGISTRY, reduced as j_reduced
from repro.data import tokenizer as tok
from repro.lora.adapters import init_lora as j_init_lora
from repro.models import init_params as j_init_params
from repro_torch import bridge
from repro_torch.launch import (failover_demo, quickstart, rl_learning_demo,
                                serve_multi_lora)
from repro_torch.launch.serve import serve_config

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
TOL = 1e-5


def _run_example(name, argv, monkeypatch):
    """Run examples/<name>.py as a script; returns its stdout."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    out = io.StringIO()
    with redirect_stdout(out):
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return out.getvalue()


def _jax_weights(cfg, keys):
    """The JAX example's params and adapters, as numpy trees."""
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg))
    trees = [jax.tree.map(np.asarray, j_init_lora(jax.random.PRNGKey(k), cfg))
             for k in keys]
    return params, trees


def _port(params, trees, pcfg):
    return (bridge.params_from_jax(params, pcfg, "cpu"),
            [bridge.lora_from_jax(t, "cpu") for t in trees])


def _jcfg():
    return dataclasses.replace(j_reduced(J_REGISTRY["granite-3-2b"],
                                         dtype="float32"),
                               vocab_size=tok.VOCAB_SIZE)


def test_serve_multi_lora_streams_equal_the_example(monkeypatch):
    seen = []
    generate = j_engine.RolloutEngine.generate

    def recording(self, *a, **k):
        out = generate(self, *a, **k)
        seen.append(out[0])
        return out
    monkeypatch.setattr(j_engine.RolloutEngine, "generate", recording)
    text = _run_example("serve_multi_lora", ["--tenants", "4"], monkeypatch)
    assert len(seen) == 1 and len(seen[0]) == 8
    params, trees = _jax_weights(_jcfg(), [100 + t for t in range(4)])
    pcfg = serve_config("granite-3-2b", reduce=True)
    pparams, ptrees = _port(params, trees, pcfg)
    lines = []
    results, stats = serve_multi_lora.serve(pcfg, pparams, ptrees,
                                            device="cpu", log=lines.append)
    for want, have in zip(seen[0], results):
        assert have["task_id"] == want["task_id"]
        assert list(have["tokens"]) == list(want["tokens"])
    # the per-request lines print alike
    want_rows = [x for x in text.splitlines() if x.startswith("  tenant-")]
    assert lines[1:] == want_rows


def test_quickstart_two_steps_equal_the_example(monkeypatch):
    metrics, rewards = [], []
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)

        def call(*args, **kw):
            out = jitted(*args, **kw)
            if isinstance(out, tuple) and len(out) == 3 \
                    and isinstance(out[2], dict) and "entropy" in out[2]:
                metrics.append({k: float(out[2][k]) for k in ("loss",
                                                              "entropy")})
            return out
        return call
    pack = j_engine.to_trajectory_batch

    def recording_pack(*a, **k):
        tb = pack(*a, **k)
        rewards.append(float(np.mean(tb.rewards)))
        return tb
    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(j_engine, "to_trajectory_batch", recording_pack)
    _run_example("quickstart", ["--steps", "2"], monkeypatch)
    monkeypatch.undo()
    assert len(metrics) == 2 and len(rewards) == 2
    params, (tree,) = _jax_weights(_jcfg(), [0])
    pcfg = serve_config("granite-3-2b", reduce=True)
    pparams, (ptree,) = _port(params, [tree], pcfg)
    have, _ = quickstart.run(pcfg, pparams, ptree, steps=2, device="cpu",
                             log=lambda *_: None)
    for h, m, r in zip(have, metrics, rewards):
        assert h["reward"] == pytest.approx(r, abs=1e-7)
        assert h["loss"] == pytest.approx(m["loss"], abs=TOL)
        assert h["entropy"] == pytest.approx(m["entropy"], abs=TOL)


def test_failover_demo_restarts_with_an_exact_row_account(tmp_path):
    cfg = serve_config("granite-3-2b", reduce=True)
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    done, acc = failover_demo.run(cfg, params, device="cpu",
                                  checkpoint_dir=str(tmp_path),
                                  log=lambda *_: None)
    c = done.rec.counters_snapshot()
    assert c.get("checkpoint_restarts", 0) >= 1
    assert c.get("supervisor_prefill_worker_restarts", 0) >= 1
    assert done.mgr.all_done()
    assert all(st.version == 4 for _, st in done.mgr.task_items())
    assert acc["completed"] == sum(acc[k] for k in (
        "trained", "stale_dropped", "discarded_tails", "failed",
        "quarantine_dropped", "orphaned"))
    assert acc["trained"] == 16


def test_rl_learning_demo_runs_both_stages():
    cfg = rl_learning_demo.demo_config()
    assert (cfg.lora.rank, cfg.lora.alpha) == (8, 32.0)
    from repro_torch.lora.adapters import init_lora
    from repro_torch.models import init_params
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    res = rl_learning_demo.run(cfg, params, init_lora(cfg, g, "cpu"),
                               device="cpu", sft_steps=3, rounds=2,
                               log=lambda *_: None)
    assert np.isfinite(res["sft_loss"]) and len(res["rewards"]) == 2
    assert all(0.0 <= r <= 1.0 for r in res["rewards"])


@pytest.mark.parametrize("module,argv", [
    (serve_multi_lora, ["--reduced", "--device", "cpu", "--tenants", "2"]),
    (quickstart, ["--reduced", "--device", "cpu", "--steps", "1"]),
])
def test_cli_on_cpu_prints_the_launch_line(module, argv, capsys):
    module.main(argv)
    lines = capsys.readouterr().out.splitlines()
    got = [json.loads(x[len("launches "):]) for x in lines
           if x.startswith("launches ")]
    assert len(got) == 1
    assert set(got[0]) == {"gqa_decode", "paged_gqa_decode", "sgmv",
                           "token_logprob_fwd", "token_logprob_bwd"}


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_multi_lora.main(["--reduced"])
