"""The port stands alone: repro_torch imports neither jax nor any module of
the JAX package `repro`, checked at run time (a fresh interpreter imports
every module of the slice and inspects sys.modules, and loads a snapshot
the JAX package wrote) and in the source (an AST scan of every file of the
package)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"

SLICE_MODULES = [
    "repro_torch", "repro_torch.bridge", "repro_torch.configs",
    "repro_torch.data.tokenizer", "repro_torch.envs.base",
    "repro_torch.envs.tasks", "repro_torch.kernels",
    "repro_torch.kernels._build", "repro_torch.kernels.gqa_decode",
    "repro_torch.kernels.ops", "repro_torch.kernels.paged_decode",
    "repro_torch.kernels.ref",
    "repro_torch.kernels.sgmv", "repro_torch.launch.serve",
    "repro_torch.lora.adapters", "repro_torch.lora.multilora",
    "repro_torch.models", "repro_torch.models.attention",
    "repro_torch.models.common", "repro_torch.models.mlp",
    "repro_torch.models.mamba2", "repro_torch.models.moe",
    "repro_torch.models.model", "repro_torch.rollout.engine",
    "repro_torch.rollout.env_stage", "repro_torch.rollout.kvcache",
    "repro_torch.rollout.prefill",
    "repro_torch.rollout.prng", "repro_torch.rollout.scheduler",
    "repro_torch.kernels.token_logprob", "repro_torch.rl.grpo",
    "repro_torch.rl.types", "repro_torch.train.optimizer",
    "repro_torch.train.sft", "repro_torch.train.train_step",
    "repro_torch.core", "repro_torch.core.admission",
    "repro_torch.core.chaos", "repro_torch.core.manager",
    "repro_torch.core.metrics", "repro_torch.core.runtime",
    "repro_torch.core.supervisor", "repro_torch.launch.multi_tenant_train",
    "repro_torch.launch.analytic", "repro_torch.launch.roofline",
    "repro_torch.launch.specs", "repro_torch.launch.train",
    "repro_torch.obs", "repro_torch.obs.tracer", "repro_torch.obs.report",
    "repro_torch.checkpoint", "repro_torch.checkpoint.store",
    "repro_torch.kernels.boundary", "repro_torch.train.sharding",
    "repro_torch.launch.mesh", "repro_torch.launch.shardings",
    "repro_torch.launch.dryrun",
    "repro_torch.analysis", "repro_torch.analysis.__main__",
    "repro_torch.analysis.core", "repro_torch.analysis.launch_rules",
    "repro_torch.analysis.locks", "repro_torch.analysis.phases",
    "repro_torch.analysis.robustness", "repro_torch.analysis.runtime_validator",
    "repro_torch.analysis.tracing",
    "repro_torch.core.policies", "repro_torch.core.simulator",
    "repro_torch.launch.quickstart", "repro_torch.launch.serve_multi_lora",
    "repro_torch.launch.failover_demo", "repro_torch.launch.rl_learning_demo",
] + [f"repro_torch.configs.{a}" for a in (
    "chameleon_34b", "dbrx_132b", "deepseek_moe_16b", "gemma2_27b",
    "granite_3_2b", "mamba2_780m", "nemotron_4_340b", "qwen1_5_110b",
    "qwen3_0_6b", "qwen3_14b", "qwen3_32b", "seamless_m4t_large_v2",
    "zamba2_1_2b")]


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(SRC).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def test_every_module_is_in_the_import_check():
    found = {_module_name(p) for p in PKG.rglob("*.py")}
    found -= {"repro_torch.configs.base", "repro_torch.configs.archs",
              "repro_torch.data", "repro_torch.envs", "repro_torch.lora",
              "repro_torch.rollout", "repro_torch.launch", "repro_torch.rl",
              "repro_torch.train"}   # via the above
    assert found <= set(SLICE_MODULES), sorted(found - set(SLICE_MODULES))


def test_import_leaves_jax_and_repro_out():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imports(tree):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_loading_a_jax_snapshot_imports_no_jax(tmp_path):
    """A snapshot the JAX package wrote, with an ``episodes.pkl`` of its
    ``EpisodeGroup`` and ``RolloutCompletion`` records, loads in a fresh
    interpreter through ``repro_torch.checkpoint`` and the runtime's
    ``adopt_checkpoint`` path without importing jax or ``repro``."""
    import numpy as np
    from repro.checkpoint.store import save_checkpoint
    from repro.core.manager import MultiTaskManager, TaskSpec
    from repro.rl.types import RolloutCompletion
    m = MultiTaskManager(async_mode=True, max_staleness=1)
    m.submit(TaskSpec("t", "gsm8k", group_size=2, num_groups=1),
             {"layers": {"q": {"a": np.ones((2, 3), np.float32)}}},
             {"step": np.asarray(1, np.int32)})
    m.admit("t")
    for i in range(2):
        m.enqueue_episode("t", 0, (1, 0), RolloutCompletion(
            task_id="t", prompt_len=2, tokens=[1, 2, 3], gen_logprobs=[-1.0],
            gen_loss_mask=[1.0], truth="1", env=None, version=0,
            submit_index=i, meta={"group": (1, 0)}))
    path = save_checkpoint(str(tmp_path), m, step_tag="s")
    assert os.path.exists(os.path.join(path, "episodes.pkl"))
    code = (
        "import sys\n"
        "from repro_torch.bridge import lora_from_jax\n"
        "from repro_torch.checkpoint.store import load_checkpoint\n"
        "from repro_torch.core.manager import MultiTaskManager\n"
        f"m = load_checkpoint({path!r}, MultiTaskManager())\n"
        "st = m.state('t')\n"
        "lora_from_jax(st.adapters, 'cpu'); lora_from_jax(st.opt_state, 'cpu')\n"
        "rows = [c for g in m.episodes['t'] for c in g.rows]\n"
        "assert len(rows) == 2 and type(rows[0]).__module__ == "
        "'repro_torch.rl.types', rows\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
