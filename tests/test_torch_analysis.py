"""The port's analyzer (``repro_torch.analysis``) against the reference's.

- Every RA1xx fixture of ``tests/test_analysis.py`` (its module constants
  and the snippets its ``test_ra1*`` tests pass to ``_findings``) goes
  through both analyzers, with equal ``(rule, line, message)`` lists.
- Bad and clean fixtures for RT201-RT203 (decode-step functions marked
  ``# step:``) and RT301-RT303 (a ``_build.py`` with ``SIGNATURES``, a
  ``csrc/*.cu`` source and a kernel module calling its launcher: an
  argument dropped, a ``float`` for an ``int``, a call one argument short,
  launchers on one side only).
- The gate: ``python -m repro_torch.analysis --check src/repro_torch`` exits
  0 against the port's ``baseline.json``, and 1 on a copy of the kernels
  with one launcher argument dropped; RT301-RT303 find nothing on the real
  kernels; the reference analyzer adds nothing over ``src/``.
- ``LockOrderRecorder`` (rooted at ``src/repro_torch``) over a short CPU
  run of the port's engine, manager and metrics, against the port's
  static lock model, as ``tests/test_analysis.py:782`` does.
- ``RecompileSentinel``: no new plan, library load or step signature over
  steady-state CPU decode; a new plan entry and a new step signature when
  a step changes shape."""
import ast
import os
import random
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import test_analysis as ref_tests
from repro.analysis import analyze_paths as ref_analyze
from repro.analysis import diff_against_baseline as ref_diff
from repro.analysis import load_baseline as ref_load_baseline
from repro_torch.analysis import (LockOrderRecorder, RecompileSentinel,
                                  analyze_paths, diff_against_baseline,
                                  load_baseline)
from repro_torch.analysis import launch_rules
from repro_torch.analysis.core import load_source

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
PORT = SRC / "repro_torch"


def _write(tmp_path, code, name="snippet.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(code))
    return p


def _found(paths):
    found, _ = analyze_paths([str(p) for p in paths])
    return found


def _triples(found):
    return [(f.rule, f.line, f.message) for f in found]


def _ra1_fixtures():
    """The RA1xx snippets of tests/test_analysis.py: its module-level
    fixture strings and the literals its test_ra1* tests analyze."""
    tree = ast.parse(Path(ref_tests.__file__).read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str) \
                and node.targets[0].id.isupper():
            out[node.targets[0].id] = node.value.value
        if isinstance(node, ast.FunctionDef) \
                and node.name.startswith("test_ra1"):
            for call in ast.walk(node):
                if isinstance(call, ast.Call) \
                        and getattr(call.func, "id", "") == "_findings" \
                        and len(call.args) > 1 \
                        and isinstance(call.args[1], ast.Constant):
                    out[node.name] = call.args[1].value
    return out


RA1 = _ra1_fixtures()


def test_the_reference_fixtures_were_found():
    assert {"LOCK_CYCLE_BAD", "GUARDED_BAD", "BLOCKING_BAD", "PHASE_BAD_TYPO",
            "PHASE_GOOD"} <= set(RA1)
    assert len(RA1) == 11        # 7 module constants, 4 inline snippets


@pytest.mark.parametrize("name", sorted(RA1))
def test_ra1_fixture_equals_reference(name, tmp_path):
    p = _write(tmp_path, RA1[name])
    want, _ = ref_analyze([str(p)])
    have = _found([p])
    assert _triples(have) == _triples(want)
    assert all(f.rule.startswith("RA1") for f in have)


# -- RT2xx: the decode step ------------------------------------------------

STEP_BAD = """
    import numpy as np
    import torch

    def _sync(dev):
        torch.cuda.synchronize(dev)

    class Engine:
        def step(self, rows):  # step: the step; tensors=_cache
            pos = self._cache["pos"]
            if pos.max() > 3:                          # RT201
                pass
            n = pos.sum().item()                       # RT202
            first = self._d_cur.cpu()                  # RT202
            x = float(pos[0])                          # RT202
            _sync(pos.device)                          # RT202 (helper)
            torch.cuda.current_stream().synchronize()  # RT202
            t = torch.from_numpy(np.zeros(3)).to("cuda")   # RT202
            buf = torch.zeros((len(rows), 4))          # RT203
            y = pos if pos.all() else None             # RT201
            return n, first, x, t, buf, y
"""

STEP_CLEAN = """
    import numpy as np
    import torch

    def _bucket_len(n):
        return 1 << max(n - 1, 0).bit_length()

    class Engine:
        def step(self, rows):  # step: the step; tensors=_cache
            pos = self._cache["pos"]
            if self._cache is None or "tbl" in self._cache:
                pass
            if pos.shape[0] > 3 and pos.dtype == torch.int32:
                pass
            nxt = self._step_fn(pos).cpu().numpy()  # noqa: RT202 (intended)
            buf = torch.zeros((_bucket_len(len(rows)), 4))
            return [int(t) for t in nxt], buf

        def helper(self):              # not on the step: not checked
            return self._cache["pos"].sum().item()
"""


def test_rt2xx_flag_the_step(tmp_path):
    found = _found([_write(tmp_path, STEP_BAD)])
    rules = [(f.rule, f.line) for f in found]
    assert rules == [("RT201", 11), ("RT202", 13), ("RT202", 14),
                     ("RT202", 15), ("RT202", 16), ("RT202", 17),
                     ("RT202", 18), ("RT203", 19), ("RT201", 20)]
    assert "`_sync()`" in found[4].message
    assert "pageable" in found[6].message


def test_rt2xx_clean_step(tmp_path):
    assert _found([_write(tmp_path, STEP_CLEAN)]) == []


def test_rt2xx_only_marked_functions(tmp_path):
    code = STEP_BAD.replace("  # step: the step; tensors=_cache", "")
    assert _found([_write(tmp_path, code)]) == []


def test_rt2xx_marker_between_signature_and_body(tmp_path):
    code = """
        def core(cfg, pos,
                 keys):
            # step: the body; tensors=pos,
            # keys
            return pos.item() + keys.item()
    """
    found = _found([_write(tmp_path, code)])
    assert [(f.rule, f.line) for f in found] == [("RT202", 6), ("RT202", 6)]


# -- RT3xx: the launchers' C interface --------------------------------------

BUILD_PY = """
    import ctypes
    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    SIGNATURES = {
        "foo": {
            "foo_launch": [_P] * 2 + [_I, _F, _P],
        },
    }
"""
FOO_CU = """
    // a launcher: x, out, n, scale, stream
    extern "C" int foo_launch(const void* x, void* out, int n, float scale,
                              void* stream) {
      return 0;
    }
"""
FOO_PY = """
    import ctypes
    from . import _build

    def _args(n):
        return (n, 2.0)

    def foo(x, out):
        shape = _args(x.shape[0])
        return _build.library("foo").foo_launch(
            x.data_ptr(), out.data_ptr(), *shape, None)
"""


def _kernels(tmp_path, build=BUILD_PY, cu=FOO_CU, py=FOO_PY):
    k = tmp_path / "kernels"
    _write(k, build, "_build.py")
    _write(k, cu, "csrc/foo.cu")
    _write(k, py, "foo.py")
    return _found([k])


def test_rt3xx_clean(tmp_path):
    assert _kernels(tmp_path) == []


def test_rt301_dropped_argument(tmp_path):
    found = _kernels(tmp_path, build=BUILD_PY.replace("[_I, _F, _P]",
                                                      "[_F, _P]"))
    assert {f.rule for f in found} == {"RT301", "RT302"}
    rt301 = next(f for f in found if f.rule == "RT301")
    assert "4 entries" in rt301.message and "takes 5" in rt301.message


def test_rt301_float_for_int(tmp_path):
    found = _kernels(tmp_path, build=BUILD_PY.replace("[_I, _F, _P]",
                                                      "[_F, _F, _P]"))
    assert [f.rule for f in found] == ["RT301"]
    assert "argument 2 is c_float (float)" in found[0].message
    assert "takes int" in found[0].message


def test_rt302_call_one_short(tmp_path):
    found = _kernels(tmp_path, py=FOO_PY.replace("return (n, 2.0)",
                                                 "return (n,)"))
    assert [f.rule for f in found] == ["RT302"]
    assert "passes 4 arguments; its argtypes has 5" in found[0].message


def test_rt303_launchers_on_one_side(tmp_path):
    extra = FOO_CU + """
    extern "C" int bar_launch(int n) { return n; }
    """
    found = _kernels(tmp_path, cu=extra)
    assert [f.rule for f in found] == ["RT303"]
    assert "`bar_launch` is exported" in found[0].message
    found = _kernels(tmp_path, build=BUILD_PY.replace(
        '"foo_launch": [_P] * 2 + [_I, _F, _P],',
        '"foo_launch": [_P] * 2 + [_I, _F, _P], "baz_launch": [_I],'))
    assert [f.rule for f in found] == ["RT303"]
    assert "`baz_launch`, which" in found[0].message


def test_rt3xx_nothing_on_the_real_kernels():
    found = _found([PORT / "kernels"])
    assert [f for f in found if f.rule.startswith("RT3")] == []
    sigs = launch_rules.signatures(
        load_source(PORT / "kernels" / "_build.py"))
    assert sum(len(v) for v in sigs.values()) == 6


def test_rt3xx_c_classes():
    assert launch_rules.c_class("const void* q") == "pointer"
    assert launch_rules.c_class("int* launched") == "pointer"
    assert launch_rules.c_class("long long ws_k") == "long long"
    assert launch_rules.c_class("float softcap") == "float"
    assert launch_rules.c_class("int B") == "int"


# -- the gate ----------------------------------------------------------------

def _cli(*argv, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *argv], env=env, capture_output=True, text=True,
                          cwd=str(cwd))


def test_port_tree_matches_its_baseline():
    found, model = analyze_paths([str(PORT)])
    new = diff_against_baseline(found, load_baseline())
    assert new == [], "\n".join(f.format() for f in new)
    displays = {d.display for d in model.locks.values()}
    for lock in ("MultiTaskManager._mgr_lock",
                 "ContinuousRolloutEngine._queue_lock",
                 "LengthPredictor._ema_lock", "EnvStage._env_cond"):
        assert lock in displays


def test_reference_analyzer_adds_nothing_over_src():
    found, _ = ref_analyze([str(SRC)])
    assert ref_diff(found, ref_load_baseline()) == []


def test_cli_gate_on_the_port_and_on_a_dropped_argument(tmp_path):
    r = _cli("--check", "src/repro_torch")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new finding(s)" in r.stdout
    k = tmp_path / "kernels"
    shutil.copytree(PORT / "kernels", k,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    r = _cli("--check", str(k))
    assert r.returncode == 0, r.stdout + r.stderr
    build = k / "_build.py"
    text = build.read_text()
    dropped = text.replace('"sgmv_launch": [_P] * 5 + [_I] * 6',
                           '"sgmv_launch": [_P] * 5 + [_I] * 5')
    assert dropped != text
    build.write_text(dropped)
    r = _cli("--check", str(k))
    assert r.returncode == 1
    assert "RT301" in r.stdout and "RT302" in r.stdout


# -- runtime validators --------------------------------------------------------

def _requests(mk_env, Request, n=6):
    env = mk_env("gsm8k")
    rng = random.Random(3)
    reqs = []
    for i in range(n):
        prompt, truth = env.sample_prompt(rng)
        reqs.append(Request(f"t{i % 2}", i % 2, prompt, truth, env,
                            max_new_tokens=6, seed=i))
    return reqs


def _drive(eng, reqs):
    comps = {}
    for r in reqs:
        eng.submit(r)
    deadline = time.monotonic() + 120
    while not eng.idle() and time.monotonic() < deadline:
        progressed = eng.step()
        for c in eng.drain_completions():
            comps[c.submit_index] = c
        if not progressed:
            time.sleep(0.0005)
    assert len(comps) == len(reqs)
    return comps


@pytest.fixture(scope="module")
def port_run():
    """The port's engine (env stage, prefill workers), manager and metrics
    created under the port's LockOrderRecorder and driven to completion."""
    import dataclasses

    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.core.manager import MultiTaskManager, TaskSpec
    from repro_torch.core.metrics import MetricsRecorder
    from repro_torch.data import tokenizer as tok
    from repro_torch.envs.tasks import make_env
    from repro_torch.lora.adapters import init_lora
    from repro_torch.models.model import init_params
    from repro_torch.rollout.engine import (ContinuousRolloutEngine,
                                            RolloutRequest)
    cfg = dataclasses.replace(reduced(REGISTRY["granite-3-2b"],
                                      dtype="float32"),
                              vocab_size=tok.VOCAB_SIZE)
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    trees = [init_lora(cfg, g, "cpu") for _ in range(2)]
    with LockOrderRecorder() as rec:
        eng = ContinuousRolloutEngine(cfg, params, max_slots=2,
                                      max_adapters=2, max_len=96, seed=0,
                                      env_stage=True, disagg_prefill=True,
                                      device="cpu")
        mgr = MultiTaskManager()
        metrics = MetricsRecorder({"rollout": 1})
    for i, tree in enumerate(trees):
        eng.set_adapters(i, tree)
    reqs = _requests(make_env, RolloutRequest)
    comps = _drive(eng, reqs)
    mgr.submit(TaskSpec("t0", "gsm8k"))
    mgr.admit("t0")
    assert mgr.next_policy("t0") == (0, None)
    assert mgr.pop_batch(timeout=0.02) is None
    metrics.record("rollout", "decode", "t0", 0.0, 1.0)
    metrics.incr("smoke")
    yield rec, eng, reqs, comps, cfg, params, trees
    eng.shutdown()


def test_lock_recorder_validates_the_port_static_model(port_run):
    rec = port_run[0]
    _, model = analyze_paths([str(PORT)])
    problems = rec.check_against(model)
    assert problems == [], "\n".join(problems)
    by_display = {d.display: d.lock_id for d in model.locks.values()}
    for disp in ("ContinuousRolloutEngine._queue_lock",
                 "LengthPredictor._ema_lock", "MultiTaskManager._mgr_lock"):
        assert by_display[disp] in rec.sites, f"{disp} never recorded"
        assert by_display[disp].startswith("src/repro_torch/")
    edge = (by_display["ContinuousRolloutEngine._queue_lock"],
            by_display["LengthPredictor._ema_lock"])
    assert edge in rec.edges


def test_sentinel_steady_state_decode(port_run):
    _, eng, reqs, _, *_ = port_run
    sent = RecompileSentinel()
    tracked = sent.track_engine(eng)
    assert "_step_fn" in tracked
    _drive(eng, reqs)                     # the tracked functions' warm-up
    sent.mark()
    _drive(eng, reqs)
    assert sent.new_compiles() == {}, sent.cache_sizes()
    assert sent.cache_sizes()["signature:_step_fn"] >= 1


def test_sentinel_counts_a_new_shape(port_run):
    from repro_torch.envs.tasks import make_env
    from repro_torch.kernels.gqa_decode import decode_plan
    from repro_torch.rollout.engine import RolloutEngine, RolloutRequest
    *_, cfg, params, trees = port_run
    eng = RolloutEngine(cfg, params, max_len=96, seed=0, device="cpu")
    sent = RecompileSentinel()
    reqs = _requests(make_env, RolloutRequest, n=2)
    eng.generate(reqs, trees)
    assert sent.track_engine(eng) == ["_step_fn", "_prefill_fn", "_first_fn"]
    eng.generate(reqs, trees)
    sent.mark()
    eng.generate(reqs, trees)             # the same shapes: nothing new
    assert sent.new_compiles() == {}
    eng.generate(_requests(make_env, RolloutRequest, n=3), trees)
    new = sent.new_compiles()
    assert new.get("signature:_step_fn") == 1, new
    sent.mark()
    decode_plan(3, 1, 77, 1, H=2, hd=16, window=0)    # a shape never seen
    assert sent.new_compiles() == {"plan:decode_plan": 1}
    decode_plan(3, 1, 77, 1, H=2, hd=16, window=0)    # cached
    assert sent.new_compiles() == {"plan:decode_plan": 1}
