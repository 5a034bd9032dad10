"""The port's public surface against the JAX package's, read from the sources
with ``ast`` only (no import, so it does not depend on the jax version), and
the parity of the last items that scan found missing.

For every ``src/repro/**/*.py`` the file at the same path under
``src/repro_torch`` (``analysis/pallas_rules.py`` is ``analysis/launch_rules.py``
there), and for every ``examples/<name>.py`` the entry point
``repro_torch/launch/<name>.py``, must have:
  - every public module-level function and class (nested functions are
    closures, not surface);
  - every public method of those classes, dunders included;
  - every parameter of those functions and methods;
  - every field of a dataclass or NamedTuple;
  - every argparse flag.
The port may have more (``--device``, ``--reduced``, ...). What the port
leaves out by design is in ``ALLOW``, each entry with its reason; an entry
that excuses nothing (the reference lost the name, or the port gained it)
fails ``test_allowlist_has_no_stale_entry``."""
import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

from test_torch_model import ACT, CONFIGS, _adapters, _configs

ROOT = Path(__file__).resolve().parents[1]
RENAMED = {"analysis/pallas_rules.py": "analysis/launch_rules.py"}

# gap -> why the port does not have it. "*(p)" excuses parameter p anywhere.
ALLOW = {
    "*(key)": "a jax PRNG key; the port's initialisers draw from a "
              "torch.Generator (`generator`)",
    "*(use_kernel)": "the port picks kernel or plain version by the tensors' "
                     "device, so no caller chooses",
    "core/runtime.py::RuntimeConfig.use_kernel": "the port's `device` field "
                                                 "picks the kernels",
    "launch/serve.py::--use-kernel": "the port's `--device` picks the kernels",
    "examples/serve_multi_lora.py::--use-kernel": "the port's `--device` picks "
                                                  "the kernels",
    "*(interpret)": "Pallas interpret mode; a CUDA kernel has none (the CPU "
                    "runs the plain version)",
    "*(bm)": "a Pallas block size; the CUDA launchers plan their own tiles",
    "*(bk)": "a Pallas block size; the CUDA launchers plan their own tiles",
    "*(bn)": "a Pallas block size; the CUDA launchers plan their own tiles",
    "*(bv)": "a Pallas block size; the CUDA launchers plan their own tiles",
    "*(bs)": "a Pallas block size; the CUDA launchers plan their own tiles",
    "*(kw)": "`kernels/ops.py` forwards Pallas tiling and interpret options",
    "kernels/sgmv.py::sgmv_sorted": "the Pallas grid over pre-sorted rows; "
                                    "the port's `sgmv` takes a segment table "
                                    "(`sgmv_table`)",
    "kernels/ref.py::token_logprob_ref(hidden)": "named `h` in the port, as "
                                                 "in its kernel wrappers",
    "kernels/ref.py::token_logprob_ref(vocab_w)": "named `w` in the port, as "
                                                  "in its kernel wrappers",
    "launch/dryrun.py::run_cell(extra_env)": "XLA_FLAGS for a JAX subprocess; "
                                             "the port's cell runs in process "
                                             "on a fake process group",
    "launch/mesh.py::make_abstract_mesh": "jax's AbstractMesh; the port's "
                                          "meshes over the fake process group "
                                          "(`fake_world`) serve the same use",
    "launch/roofline.py::parse_collectives": "reads XLA's HLO text; the port "
                                             "counts DTensor's collectives "
                                             "(`collective_counter`)",
    "launch/shardings.py::to_named": "jax's NamedSharding; the port's specs "
                                     "become DTensor placements",
    "rollout/prefill.py::PrefillKernels.__init__(max_len)": "jit fixes the "
                                                            "worker cache's "
                                                            "length; the port "
                                                            "sizes each call "
                                                            "(`width`)",
}


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return set(names + [x.arg for x in (a.vararg, a.kwarg) if x is not None])


def _has_fields(cls):
    for d in cls.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        if getattr(d, "attr", getattr(d, "id", "")) == "dataclass":
            return True
    return any(getattr(b, "attr", getattr(b, "id", "")) == "NamedTuple"
               for b in cls.bases)


def _public(name):
    return not name.startswith("_") or (name.startswith("__")
                                        and name.endswith("__"))


def surface(source):
    """(defs, classes, bound, flags) of a module's source: module-level
    functions -> parameters; classes -> (methods -> parameters, fields or
    None); every other module-level name; the argparse flags."""
    tree = ast.parse(source)
    defs, classes, bound = {}, {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            meths = {b.name: _params(b) for b in node.body
                     if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
            fields = {b.target.id for b in node.body
                      if isinstance(b, ast.AnnAssign)
                      and isinstance(b.target, ast.Name)}
            classes[node.name] = (meths, fields if _has_fields(node) else None)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            bound |= {n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound |= {(a.asname or a.name).split(".")[0] for a in node.names}
    flags = {a.value for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "add_argument"
             for a in n.args
             if isinstance(a, ast.Constant) and isinstance(a.value, str)
             and a.value.startswith("-")}
    return defs, classes, bound, flags


def mirrored(ref_root, port_root, examples_root=None):
    """(name, reference file, port file) for every reference module, and for
    every example its entry point under the port's ``launch/``."""
    for f in sorted(Path(ref_root).rglob("*.py")):
        rel = f.relative_to(ref_root).as_posix()
        yield rel, f, Path(port_root) / RENAMED.get(rel, rel)
    if examples_root is not None:
        for f in sorted(Path(examples_root).glob("*.py")):
            yield f"examples/{f.name}", f, Path(port_root) / "launch" / f.name


def surface_gaps(pairs):
    """Every public name, parameter, field and flag of a reference file that
    its port file lacks, as "file::name", "file::Class.member",
    "file::function(parameter)", "file::--flag" or "file::<file>"."""
    gaps = set()
    for rel, ref, port in pairs:
        if not port.exists():
            gaps.add(f"{rel}::<file>")
            continue
        rdefs, rclasses, _, rflags = surface(ref.read_text())
        pdefs, pclasses, pbound, pflags = surface(port.read_text())
        names = set(pdefs) | set(pclasses) | pbound
        for name, params in rdefs.items():
            if not _public(name):
                continue
            if name not in names:
                gaps.add(f"{rel}::{name}")
            elif name in pdefs:
                gaps |= {f"{rel}::{name}({p})" for p in params - pdefs[name]}
        for name, (meths, fields) in rclasses.items():
            if not _public(name):
                continue
            if name not in names:
                gaps.add(f"{rel}::{name}")
                continue
            if name not in pclasses:
                continue
            pmeths, pfields = pclasses[name]
            for m, params in meths.items():
                if not _public(m):
                    continue
                if m not in pmeths:
                    gaps.add(f"{rel}::{name}.{m}")
                else:
                    gaps |= {f"{rel}::{name}.{m}({p})"
                             for p in params - pmeths[m]}
            gaps |= {f"{rel}::{name}.{f}" for f in (fields or set())
                     - (pfields or set())}
        gaps |= {f"{rel}::{fl}" for fl in rflags - pflags}
    return gaps


def _allowed_by(gap):
    param = re.search(r"\((\w+)\)$", gap)
    return [k for k in (gap, f"*({param.group(1)})" if param else None)
            if k in ALLOW]


@pytest.fixture(scope="module")
def repo_gaps():
    return surface_gaps(mirrored(ROOT / "src" / "repro",
                                 ROOT / "src" / "repro_torch",
                                 ROOT / "examples"))


def test_every_reference_name_has_its_counterpart(repo_gaps):
    missing = sorted(g for g in repo_gaps if not _allowed_by(g))
    assert not missing, ("the port lacks these names of the JAX package "
                         f"(port them, or allow one with a reason): {missing}")


def test_allowlist_has_no_stale_entry(repo_gaps):
    used = {k for g in repo_gaps for k in _allowed_by(g)}
    stale = sorted(set(ALLOW) - used)
    assert not stale, f"allowlist entries that excuse no gap: {stale}"
    assert all(len(reason) > 20 for reason in ALLOW.values())


# -- the scan on two synthetic packages: it reports what was removed --------

REF_SOURCE = '''
import argparse
from dataclasses import dataclass
from typing import NamedTuple


def f(a, b, *, c=1):
    def inner(z):
        return z
    return inner(a)


def _private(x):
    return x


class K:
    def __init__(self, p):
        self.p = p

    def m(self, q):
        return q

    def _hidden(self):
        return 0


@dataclass
class D:
    x: int = 0
    y: int = 1


class N(NamedTuple):
    u: int
    v: int


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--flag", type=int, default=0)
'''

REMOVALS = {   # what the port's copy loses -> the gap the scan must report
    "function": (("def f(a, b, *, c=1):", "def g(a, b, *, c=1):"), "m.py::f"),
    "parameter": (("def f(a, b, *, c=1):", "def f(a, b):"), "m.py::f(c)"),
    "class": (("class K:", "class KK:"), "m.py::K"),
    "method": (("def m(self, q):", "def mm(self, q):"), "m.py::K.m"),
    "method parameter": (("def m(self, q):", "def m(self):"), "m.py::K.m(q)"),
    "constructor parameter": (("def __init__(self, p):", "def __init__(self):"),
                              "m.py::K.__init__(p)"),
    "dataclass field": (("    y: int = 1\n", ""), "m.py::D.y"),
    "namedtuple field": (("    v: int\n", ""), "m.py::N.v"),
    "flag": (('"--flag"', '"--other"'), "m.py::--flag"),
}


def _synthetic(tmp_path, port_source):
    (tmp_path / "ref" / "sub").mkdir(parents=True)
    (tmp_path / "port" / "sub").mkdir(parents=True)
    (tmp_path / "ref" / "m.py").write_text(REF_SOURCE)
    (tmp_path / "ref" / "sub" / "other.py").write_text("def h(x):\n    return x\n")
    (tmp_path / "port" / "sub" / "other.py").write_text("def h(x, y=0):\n    return x\n")
    if port_source is not None:
        (tmp_path / "port" / "m.py").write_text(port_source)
    return surface_gaps(mirrored(tmp_path / "ref", tmp_path / "port"))


def test_scan_of_a_full_copy_reports_nothing(tmp_path):
    """Private names, nested functions and the port's extra parameters and
    flags are not gaps."""
    port = (REF_SOURCE.replace("    def inner(z):\n        return z\n", "")
            .replace("return inner(a)", "return a")
            .replace("def _private(x):\n    return x\n", "")
            .replace("    def _hidden(self):\n        return 0\n", "")
            .replace("def m(self, q):", "def m(self, q, extra=None):")
            .replace('ap.add_argument("--flag", type=int, default=0)',
                     'ap.add_argument("--flag", type=int, default=0)\n'
                     '    ap.add_argument("--device", default="cuda")'))
    assert _synthetic(tmp_path, port) == set()


@pytest.mark.parametrize("removed", sorted(REMOVALS))
def test_scan_reports_a_removed_name(tmp_path, removed):
    (old, new), gap = REMOVALS[removed]
    assert old in REF_SOURCE
    assert _synthetic(tmp_path, REF_SOURCE.replace(old, new)) == {gap}


def test_scan_reports_a_missing_file(tmp_path):
    assert _synthetic(tmp_path, None) == {"m.py::<file>"}


# ---------------------------------------------------------------------------
# the items the scan found missing, against the JAX package
# ---------------------------------------------------------------------------

POOL_FLAGS = ("--kv-page-size", "--kv-pool-pages", "--no-resume-restore",
              "--snapshot-budget-bytes", "--no-prefix-cache")


def _flag_options(path):
    """flag -> its add_argument keywords, as source text."""
    out = {}
    for n in ast.walk(ast.parse(path.read_text())):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "add_argument" and n.args
                and isinstance(n.args[0], ast.Constant)):
            out[n.args[0].value] = {k.arg: (k.value.value
                                            if isinstance(k.value, ast.Constant)
                                            else ast.unparse(k.value))
                                    for k in n.keywords}
    return out


def _without_one_aside(text):
    """``text`` with each of its parenthesised asides left out, one at a time."""
    return {text[:m.start()] + text[m.end():]
            for m in re.finditer(r" \([^()]*\)", text)}


@pytest.mark.parametrize("flag", POOL_FLAGS)
def test_pool_flag_is_the_reference_cli_s(flag):
    """Name, type, action and default as the reference's; the help text the
    reference's, or it less one parenthesised aside."""
    ref = _flag_options(ROOT / "examples" / "multi_tenant_train.py")[flag]
    port = _flag_options(ROOT / "src" / "repro_torch" / "launch"
                         / "multi_tenant_train.py")[flag]
    assert {k: v for k, v in port.items() if k != "help"} == \
        {k: v for k, v in ref.items() if k != "help"}
    assert port["help"] == ref["help"] or port["help"] in \
        _without_one_aside(ref["help"])


POOL_CASES = {
    "defaults": ([], dict(kv_page_size=16, kv_pool_pages=0, resume_restore=True,
                          snapshot_budget_bytes=0, prefix_cache=True),
                 "pool: page_size=16 pages=32 prefix_cache=on resume_restore=on "
                 "snapshot_budget_bytes=unlimited"),
    "set": (["--kv-page-size", "8", "--kv-pool-pages", "40", "--no-prefix-cache",
             "--no-resume-restore", "--snapshot-budget-bytes", "4096"],
            dict(kv_page_size=8, kv_pool_pages=40, resume_restore=False,
                 snapshot_budget_bytes=4096, prefix_cache=False),
            "pool: page_size=8 pages=40 prefix_cache=off resume_restore=off "
            "snapshot_budget_bytes=4096"),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_flags_reach_the_engine(case, capsys):
    """The runtime CLI's five pool flags reach RuntimeConfig and the engine:
    a one-step run of two tenants on the tiny preset."""
    from repro_torch.launch import multi_tenant_train
    args, want, line = POOL_CASES[case]
    rt = multi_tenant_train.main(["--preset", "tiny", "--device", "cpu",
                                  "--tasks", "2", "--steps", "1", "--paged-kv",
                                  *args])
    assert {k: getattr(rt.rcfg, k) for k in want} == want
    eng = rt.cengine
    assert (eng.kv_page_size, eng.prefix_cache, eng.resume_restore,
            eng._snap_store.budget_bytes) == (
        want["kv_page_size"], want["prefix_cache"], want["resume_restore"],
        want["snapshot_budget_bytes"])
    assert eng.page_stats()["kv_pages_total"] == (
        want["kv_pool_pages"] or 8 * 64 // want["kv_page_size"])
    assert [st.version for _, st in rt.mgr.task_items()] == [1, 1]
    out = capsys.readouterr().out
    assert line in out.splitlines()
    assert "launches {" in out


# -- forward_seq(inputs_embeds=) ---------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_forward_seq_inputs_embeds_matches_jax(name):
    """The embeddings in place of the ids, with batched adapters and a cache:
    equal to the JAX package's at ACT, and bit-equal to the port's own
    tokens path."""
    import jax
    import jax.numpy as jnp
    from repro.lora.adapters import batched_ctx as jax_batched_ctx
    from repro.lora.adapters import stack_adapters as jax_stack
    from repro.models import forward_seq as jax_forward_seq
    from repro.models import init_cache as jax_init_cache
    from repro.models import init_params as jax_init_params
    from repro_torch import bridge
    from repro_torch.lora.adapters import batched_ctx, stack_adapters
    from repro_torch.models import forward_seq, init_cache

    jcfg, pcfg = _configs(name)
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    trees = _adapters(jcfg, 2, seed=5)
    pparams = bridge.params_from_jax(jp, pcfg, "cpu")
    pstack = stack_adapters([bridge.lora_from_jax(t, "cpu") for t in trees])
    rs = np.random.RandomState(6)
    B, S, max_len = 3, 8, 16
    tokens = rs.randint(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    ids = np.array([0, 1, 0], np.int32)
    jparams = jax.tree.map(jnp.asarray, jp)
    jh, jcache, _ = jax_forward_seq(
        jparams, None, jcfg,
        jax_batched_ctx(jax_stack([jax.tree.map(jnp.asarray, t) for t in trees]),
                        jnp.asarray(ids), jcfg),
        jax_init_cache(jcfg, B, max_len),
        inputs_embeds=jparams["embed"][jnp.asarray(tokens)])
    lora = batched_ctx(pstack, torch.from_numpy(ids), pcfg)
    t = torch.from_numpy(tokens)
    ph, pcache, _ = forward_seq(pparams, None, pcfg, lora,
                                init_cache(pcfg, B, max_len, device="cpu"),
                                inputs_embeds=pparams["embed"][t.long()])
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **ACT)
    for k in ("k", "v"):
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(jcache[k]), **ACT)
    th, tcache, _ = forward_seq(pparams, t, pcfg, lora,
                                init_cache(pcfg, B, max_len, device="cpu"))
    assert torch.equal(ph, th)
    assert all(torch.equal(pcache[k], tcache[k]) for k in ("k", "v"))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-780m",
                                  "zamba2-1.2b"])
def test_forward_seq_inputs_embeds_other_families(arch):
    """The moe, ssm and hybrid families: the embeddings path bit-equal to the
    tokens path, with the cache and `seq_lens`."""
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.models import forward_seq, init_cache, init_params

    cfg = reduced(REGISTRY[arch], dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    lens = torch.tensor([16, 11])
    out = [forward_seq(params, tok, cfg, None, init_cache(cfg, 2, 32, device="cpu"),
                       inputs_embeds=emb, seq_lens=lens)
           for tok, emb in ((tokens, None), (None, params["embed"][tokens]))]
    (h0, c0, a0), (h1, c1, a1) = out
    assert torch.equal(h0, h1) and torch.equal(a0, a1)
    assert c0.keys() == c1.keys()
    assert all(torch.equal(c0[k], c1[k]) for k in c0)


# -- the two LoRA helpers ----------------------------------------------------

def _archs():
    import repro_torch.configs as pc
    return sorted(pc.REGISTRY)


@pytest.mark.parametrize("arch", _archs())
def test_lora_param_count_matches_reference(arch):
    from repro.configs import REGISTRY as JREG
    from repro.lora.adapters import lora_param_count as jax_count
    from repro_torch.configs import REGISTRY
    from repro_torch.lora.adapters import lora_param_count

    assert dataclasses.asdict(REGISTRY[arch]) == dataclasses.asdict(JREG[arch])
    assert lora_param_count(REGISTRY[arch]) == jax_count(JREG[arch])


@pytest.mark.parametrize("num_tasks,n", [(1, 5), (4, 33), (8, 3), (16, 256)])
def test_sort_rows_by_task_matches_reference(num_tasks, n):
    import jax.numpy as jnp
    from repro.lora.multilora import sort_rows_by_task as jax_sort
    from repro_torch.lora.multilora import sort_rows_by_task

    ids = np.random.RandomState(num_tasks * 1000 + n).randint(
        0, num_tasks, size=n).astype(np.int32)
    want_order, want_off = jax_sort(jnp.asarray(ids), num_tasks)
    order, off = sort_rows_by_task(torch.from_numpy(ids), num_tasks)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))
    assert off.dtype == torch.int32 and off.shape == (num_tasks + 1,)
