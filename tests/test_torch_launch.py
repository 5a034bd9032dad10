"""The port's launch layer against the JAX package's: ``launch.specs``
(shape trees on the meta device and the step builders), ``launch.analytic``
(a copy), ``launch.roofline`` (the card's peaks) and the ``launch.train``
CLI.

- Shape trees: for every assigned config at full size and each of its
  shape cells (``shapes_for``: 32 cells), ``eval_shapes`` and the cell's
  ``train_batch_specs`` or ``serve_specs`` against ``jax.eval_shape``'s
  trees leaf by leaf: the same paths, shapes and dtypes, and no memory.
- Step builders on the reduced fp32 configs (conftest.tiny), the same numpy
  inputs and bridged weights: the multi-LoRA prefill and decode steps
  (logits 1e-4, caches 1e-5) and the LoRA GRPO step (loss and metrics
  1e-5, absolute 1e-6; adapters 1e-6 where the step is determined, as in
  tests/test_torch_train.py).
- ``analytic_terms`` and ``model_flops_for``: exactly equal over the cells
  and a few (chips, dp, tp)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny
from repro.configs import ASSIGNED as J_ASSIGNED, ShapeConfig as JShape
from repro.configs import shapes_for as j_shapes_for
from repro.launch import analytic as j_analytic
from repro.launch import roofline as j_roofline
from repro.launch import specs as j_specs
from repro.lora.adapters import init_lora, stack_adapters as jax_stack
from repro.models import init_cache as jax_init_cache, init_params
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.configs import (ASSIGNED, REGISTRY as PT_REGISTRY,
                                 ShapeConfig, reduced as pt_reduced, shapes_for)
from repro_torch.launch import analytic, roofline, specs
from repro_torch.lora.adapters import stack_adapters
from repro_torch.models import init_cache
from repro_torch.train.optimizer import adamw_init

ACT = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = 1e-6
CELLS = [(cfg.name, s.name) for cfg in ASSIGNED for s in shapes_for(cfg)]
MESHES = [(1, 1, 1), (4, 4, 1), (4, 1, 4), (256, 32, 8)]


def test_the_cells_are_the_references():
    assert len(CELLS) == 32 and len(ASSIGNED) == 10
    assert CELLS == [(c.name, s.name) for c in J_ASSIGNED
                     for s in j_shapes_for(c)]
    for c, jc in zip(ASSIGNED, J_ASSIGNED):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert (specs.NUM_TENANTS, specs.GROUP_SIZE, specs.MICRO_ROWS,
            specs.DEFAULT_MICRO_ROWS) == (j_specs.NUM_TENANTS,
                                          j_specs.GROUP_SIZE,
                                          j_specs.MICRO_ROWS,
                                          j_specs.DEFAULT_MICRO_ROWS)


def _sig(tree, prefix=""):
    """{path: (shape, dtype name)} of a JAX shape tree or a port tree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_sig(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_sig(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX package's eval_shapes per config, computed once (it traces
    every layer's init)."""
    cache = {}

    def get(cfg):
        if cfg.name not in cache:
            cache[cfg.name] = _sig(j_specs.eval_shapes(cfg))
        return cache[cfg.name]
    return get


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("arch,cell", CELLS)
def test_shape_trees_equal_the_references(arch, cell, jax_trees):
    cfg = PT_REGISTRY[arch]
    jcfg = next(c for c in J_ASSIGNED if c.name == arch)
    shape = next(s for s in shapes_for(cfg) if s.name == cell)
    jshape = next(s for s in j_shapes_for(jcfg) if s.name == cell)
    trees = specs.eval_shapes(cfg)
    assert _sig(trees) == jax_trees(jcfg)
    if shape.kind == "train":
        got, want = (specs.train_batch_specs(cfg, shape),
                     j_specs.train_batch_specs(jcfg, jshape))
    else:
        got, want = (specs.serve_specs(cfg, shape),
                     j_specs.serve_specs(jcfg, jshape))
    assert _sig(got) == _sig(want)
    assert ("enc_embeds" in got) == (cfg.family == "encdec"
                                     and shape.kind != "decode")
    for t in _leaves(trees) + _leaves(got):
        assert t.device.type == "meta"
    assert specs.accum_steps(cfg, shape) == j_specs.accum_steps(jcfg, jshape)


@pytest.mark.parametrize("arch,cell", CELLS)
def test_analytic_terms_and_model_flops_equal_the_references(arch, cell):
    cfg = PT_REGISTRY[arch]
    jcfg = next(c for c in J_ASSIGNED if c.name == arch)
    shape = next(s for s in shapes_for(cfg) if s.name == cell)
    jshape = next(s for s in j_shapes_for(jcfg) if s.name == cell)
    assert roofline.model_flops_for(cfg, shape) == \
        j_roofline.model_flops_for(jcfg, jshape)
    for ctx in (1.0, 4096.0):
        for seq in (False, True):
            assert analytic.fwd_flops_per_token(cfg, ctx, seq) == \
                j_analytic.fwd_flops_per_token(jcfg, ctx, seq)
    for chips, dp, tp in MESHES:
        for accum, vpl in ((1, False), (specs.accum_steps(cfg, shape), True)):
            got = analytic.analytic_terms(cfg, shape, chips, dp, tp, accum, vpl)
            want = j_analytic.analytic_terms(jcfg, jshape, chips, dp, tp,
                                             accum, vpl)
            assert got.as_dict() == want.as_dict()


def test_roofline_terms_follow_the_references_formulas():
    """roofline() on the reference's TPU constants gives the reference's
    fields exactly; the card's peaks come from the data sheet by name, and
    an unknown card raises."""
    tpu = roofline.Peaks("v5e", {"bfloat16": j_roofline.PEAK_FLOPS},
                         hbm_bytes_per_s=j_roofline.HBM_BW,
                         nvlink_bytes_per_s=2 * j_roofline.LINK_BW)
    cost = {"flops": 3.5e14, "bytes accessed": 2.25e11}
    for coll_bytes, chips in ((0.0, 1), (7.5e9, 4), (1e12, 256)):
        jc = j_roofline.CollectiveStats(total_per_chip=coll_bytes)
        pc = roofline.CollectiveStats(total_per_chip=coll_bytes)
        want = j_roofline.roofline(cost, jc, chips, 1.25e14).as_dict()
        got = roofline.roofline(cost, pc, chips, 1.25e14, peaks=tpu,
                                card="x").as_dict()
        assert got.pop("card") == "x"
        assert got == want
    h100 = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert h100 is roofline.H100_SXM
    assert h100.flops == {"bfloat16": 989e12, "float32": 67e12}
    assert (h100.hbm_bytes_per_s, h100.nvlink_bytes_per_s,
            h100.link_bytes_per_s) == (3.35e12, 900e9, 450e9)
    with pytest.raises(KeyError, match="A100"):
        roofline.peaks_for("NVIDIA A100-SXM4-80GB")
    assert roofline.share_of_peak(989e12, 2.0, h100) == 0.5


# ---------------------------------------------------------------------------
# the step builders on reduced configs
# ---------------------------------------------------------------------------

def _configs(arch):
    jcfg = tiny(arch)
    pcfg = pt_reduced(PT_REGISTRY[arch], dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tenants(jcfg, n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for t in range(n):
        tree = _np_tree(init_lora(jax.random.PRNGKey(20 + t), jcfg))
        for sub in tree.values():
            for leaf in sub.values():
                leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.2).astype(np.float32)
        out.append(tree)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "granite-3-2b"])
def test_prefill_and_decode_steps_match_the_references(arch):
    """build_prefill_step over NUM_TENANTS stacked adapters (rows on 4 of
    them, mixed prompt lengths), then three build_decode_step steps: logits
    and every cache entry against the JAX step builders'."""
    jcfg, pcfg = _configs(arch)
    jp = _np_tree(init_params(jax.random.PRNGKey(0), jcfg))
    trees = _tenants(jcfg, specs.NUM_TENANTS, seed=1)
    jparams = jax.tree.map(jnp.asarray, jp)
    pparams = bridge.params_from_jax(jp, pcfg, "cpu")
    jads = jax_stack([jax.tree.map(jnp.asarray, t) for t in trees])
    pads = stack_adapters([bridge.lora_from_jax(t, "cpu") for t in trees])
    B, S, max_len = 4, 16, 24
    rs = np.random.RandomState(2)
    toks = rs.randint(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([16, 9, 12, 5], np.int32)
    ids = np.array([0, 3, 5, 7], np.int32)
    enc_len = S // 4 if pcfg.family == "encdec" else 0
    enc = rs.randn(B, enc_len, jcfg.d_model).astype(np.float32)
    kw_j = {"enc_embeds": jnp.asarray(enc)} if enc_len else {}
    kw_p = {"enc_embeds": _t(enc)} if enc_len else {}
    jlog, jc = j_specs.build_prefill_step(jcfg)(
        jparams, jads, jnp.asarray(ids), jnp.asarray(toks), jnp.asarray(lens),
        jax_init_cache(jcfg, B, max_len, enc_len=enc_len), **kw_j)
    plog, pc = specs.build_prefill_step(pcfg)(
        pparams, pads, _t(ids), _t(toks), _t(lens),
        init_cache(pcfg, B, max_len, enc_len=enc_len, device="cpu"), **kw_p)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGITS)
    assert pc["pos"].dtype == torch.int32
    jstep, pstep = j_specs.build_decode_step(jcfg), specs.build_decode_step(pcfg)
    for t in range(3):
        cur = rs.randint(1, jcfg.vocab_size, size=(B,)).astype(np.int32)
        jlog, jc = jstep(jparams, jads, jnp.asarray(ids), jnp.asarray(cur), jc)
        plog, pc = pstep(pparams, pads, _t(ids), _t(cur), pc)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGITS)
    assert set(pc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **ACT)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("remat_block", ["", "1", "2"])
def test_train_step_matches_the_reference(remat_block, monkeypatch):
    """build_train_step on seamless (enc_embeds in the batch; the port's
    fused token_logprob path, its plain version here, against the JAX
    step's chunked one; REPRO_REMAT_BLOCK set in both packages'
    environment) against the JAX step builder's: 16 rows in 2 GRPO groups
    of GROUP_SIZE, one micro-batch."""
    if remat_block:
        monkeypatch.setenv("REPRO_REMAT_BLOCK", remat_block)
    jcfg, pcfg = _configs("seamless-m4t-large-v2")
    shape = ShapeConfig("t", 12, 16, "train")
    jshape = JShape("t", 12, 16, "train")
    assert specs.accum_steps(pcfg, shape) == 1
    assert specs.maybe_remat_block(pcfg).remat_block == int(remat_block or 0)
    jp = _np_tree(init_params(jax.random.PRNGKey(0), jcfg))
    lora = _tenants(jcfg, 1, seed=3)[0]
    rs = np.random.RandomState(4)
    R, S = 16, 12
    batch = {"tokens": rs.randint(0, jcfg.vocab_size, (R, S)).astype(np.int32),
             "prompt_lens": rs.randint(2, 6, R).astype(np.int32),
             "total_lens": rs.randint(7, 13, R).astype(np.int32),
             "rewards": rs.rand(R).astype(np.float32),
             "enc_embeds": rs.randn(R, S // 4, jcfg.d_model).astype(np.float32)}
    jparams, jlora = (jax.tree.map(jnp.asarray, t) for t in (jp, lora))
    jnew, jst, jm = j_specs.build_train_step(jcfg, jshape)(
        jparams, jlora, jax_adamw_init(jlora), jax.tree.map(jnp.asarray, batch))
    pparams = bridge.params_from_jax(jp, pcfg, "cpu")
    plora = bridge.lora_from_jax(lora, "cpu")
    pnew, _, pm = specs.build_train_step(pcfg, shape)(
        pparams, plora, adamw_init(plora), {k: _t(v) for k, v in batch.items()})
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                   rtol=1e-5, atol=1e-6)
    got, want, mom = (_flat(bridge.to_numpy(pnew)), _flat(jnew),
                      _flat(jst["m"]))
    lr = 1e-4                                    # AdamWConfig()'s default
    for k in want:
        err = np.abs(got[k] - want[k])
        sure = np.abs(10 * mom[k]) > 100 * 1e-8
        assert sure.mean() > 0.5, k               # every adapter is trained
        assert err[sure].max(initial=0) <= STEP_TOL, (k, err[sure].max())
        assert err.max() <= lr, (k, err.max())


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_reduced_and_resumes(tmp_path, capsys):
    """launch.train on the CPU: the reduced config (``--reduced`` cannot be
    turned off, as in the JAX CLI), every task to its target version, a
    snapshot a commit; --resume adopts the newest and has nothing left to
    do."""
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    rt = train.main(["--device", "cpu", "--tasks", "2", "--steps", "1",
                     "--checkpoint-dir", ck, "--checkpoint-every", "1"])
    assert rt.cfg.num_layers == 2 and rt.cfg.dtype == "float32"
    assert {t: s.version for t, s in rt.mgr.task_items()} == \
        {"gsm8k-0": 1, "amc12-1": 1}
    rt2 = train.main(["--device", "cpu", "--steps", "1", "--checkpoint-dir",
                      ck, "--resume"])
    assert "resuming from" in capsys.readouterr().out
    assert {t: s.version for t, s in rt2.mgr.task_items()} == \
        {"gsm8k-0": 1, "amc12-1": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main([])
