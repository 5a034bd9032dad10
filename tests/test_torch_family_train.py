"""The LoRA-only GRPO step on the moe (deepseek-moe), ssm (mamba2) and
hybrid (zamba2) families, and the vlm family (chameleon: a dense stack with
qk-norm over an early-fusion vocabulary) end to end, the port against the
JAX package on the same numpy inputs and bridged fp32 weights (reduced
configs, conftest.tiny; MoE at capacity_factor 8).

Tolerances, fp32 on both sides (as tests/test_torch_train.py's):
- losses and metrics 1e-5 (absolute 1e-6 below 0.1), the MoE aux included;
- parameters after one AdamW step 1e-6 where the step is determined (the
  clipped gradient above 100 eps), one step elsewhere;
- AdamW moments (m = 0.1 g, v = 0.001 g^2: the adapter gradients) at 1e-4
  of each leaf's largest element: the backward of a whole model sums in
  another order at every product;
- vlm logits 1e-4, activations 1e-5 (tests/test_torch_model.py's)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny
from repro.lora.adapters import (batched_ctx as jax_batched_ctx, init_lora,
                                 stack_adapters as jax_stack)
from repro.models import (decode_step as jax_decode_step,
                          forward_seq as jax_forward_seq,
                          forward_train as jax_forward_train,
                          init_cache as jax_init_cache, init_params)
from repro.train import optimizer as jopt
from repro.train.train_step import (TrainConfig as JTrainConfig,
                                    init_opt_state as jax_init_opt,
                                    make_train_step as jax_make_train_step)
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.lora.adapters import batched_ctx, single_ctx, stack_adapters
from repro_torch.models import (decode_step, forward_seq, forward_train,
                                init_cache, tree_leaves, tree_map)
from repro_torch.train import optimizer as popt
from repro_torch.train.train_step import (TrainConfig, init_opt_state,
                                          make_train_step)

LR = 3e-3
STEP_TOL = 1e-6
ACT = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a JAX or port tree (dicts, NamedTuples)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _model(name):
    """(JAX cfg, port cfg, numpy params, numpy adapters with random b in
    every subtree)."""
    jcfg = tiny(name)
    pcfg = pt_reduced(PT_REGISTRY[name], dtype="float32")
    if pcfg.moe is not None:
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=8.0))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    lora = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(1), jcfg))
    rs = np.random.RandomState(2)
    for sub in lora.values():
        for leaf in sub.values():
            leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.2).astype(np.float32)
    return jcfg, pcfg, params, lora


def _batch(V, seed=3):
    """4 rows in 2 GRPO groups of 2, S=12, prompts of 3-5 tokens."""
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(0, V, size=(4, 12)).astype(np.int32),
            "prompt_lens": np.array([3, 4, 5, 3], np.int32),
            "total_lens": np.array([12, 9, 11, 7], np.int32),
            "rewards": np.array([1.0, 0.0, 0.25, 0.75], np.float32)}


@pytest.mark.parametrize("case", ["default", "kl_ent"])
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-780m",
                                  "zamba2-1.2b"])
def test_lora_grpo_step_matches_jax(name, case):
    """make_train_step(trainable="lora"): loss, metrics (the MoE aux among
    them, 0 for the recurrent families), the adapters after one AdamW step
    and the moments (the gradients reach ssm_in/ssm_out and the hybrid's
    shared-block adapters) against the JAX step."""
    jcfg, pcfg, params, lora = _model(name)
    kw = dict(group_size=2)
    if case == "kl_ent":
        kw.update(kl_coef=0.05, ent_coef=0.01)
    tc_j = JTrainConfig(adamw=jopt.AdamWConfig(lr=LR), **kw)
    tc_p = TrainConfig(adamw=popt.AdamWConfig(lr=LR), **kw)
    batch = _batch(jcfg.vocab_size)
    jparams = jax.tree.map(jnp.asarray, params)
    jlora = jax.tree.map(jnp.asarray, lora)
    jnew, jst, jm = jax.jit(jax_make_train_step(jcfg, tc_j))(
        jparams, jlora, jax_init_opt(jcfg, tc_j, jparams, jlora),
        jax.tree.map(jnp.asarray, batch))
    pparams = bridge.params_from_jax(params, pcfg, "cpu")
    plora = bridge.lora_from_jax(lora, "cpu")
    pnew, pst, pm = make_train_step(pcfg, tc_p)(
        pparams, plora, init_opt_state(pcfg, tc_p, pparams, plora),
        {k: _t(v) for k, v in batch.items()})
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                   rtol=1e-5, atol=1e-6)
    assert (float(pm["aux"]) > 0) == (pcfg.family == "moe")
    assert float(pm["grad_norm"]) > 0
    got, want, m = (_flat(bridge.to_numpy(pnew)), _flat(jnew), _flat(jst["m"]))
    assert got.keys() == want.keys() == m.keys()
    assert any("shared" in k for k in got) == (pcfg.family == "hybrid")
    for k in want:
        err = np.abs(got[k] - want[k])
        sure = np.abs(10 * m[k]) > 100 * 1e-8
        assert sure.mean() > 0.5, k               # every adapter is trained
        assert err[sure].max(initial=0) <= STEP_TOL, (k, err[sure].max())
        assert err.max() <= LR, (k, err.max())
    for mom in ("m", "v"):
        pg, jg = _flat(bridge.to_numpy(pst[mom])), _flat(jst[mom])
        for k in jg:
            e = np.abs(pg[k] - jg[k]).max()
            assert e <= 1e-4 * np.abs(jg[k]).max(), (mom, k, e)


def test_moe_aux_is_a_tensor_autograd_sees():
    """The MoE load-balance loss enters the loss (``loss + 0.01 * aux``)
    with a gradient: through the router's input it reaches the attention
    adapters."""
    _, pcfg, params, lora = _model("deepseek-moe-16b")
    pparams = bridge.params_from_jax(params, pcfg, "cpu")
    plora = tree_map(lambda t: t.clone().requires_grad_(True),
                     bridge.lora_from_jax(lora, "cpu"))
    _, aux = forward_train(pparams, _t(_batch(pcfg.vocab_size)["tokens"]),
                           pcfg, single_ctx(plora, pcfg))
    assert aux.requires_grad and float(aux.detach()) > 0
    grads = torch.autograd.grad(aux, tree_leaves(plora), allow_unused=True)
    q_grad = grads[[i for i, t in enumerate(tree_leaves(plora))
                    if t is plora["layers"]["attn_q"]["a"]][0]]
    assert q_grad is not None and float(q_grad.abs().max()) > 0


def test_vlm_forward_decode_and_lora_match_jax():
    """ROADMAP §1 item 8's vlm test: reduced chameleon-34b (qk-norm, untied
    head; the JAX package treats vlm as a dense stack of token ids) through
    forward_train under a single adapter, forward_seq with a cache then two
    decode steps under batched multi-LoRA, against the JAX package; the
    batched forward equals each row's single-adapter forward."""
    jcfg, pcfg, params, lora = _model("chameleon-34b")
    assert pcfg.family == "vlm" and pcfg.qk_norm
    lora2 = jax.tree.map(np.copy, lora)
    for leaf in lora2["layers"].values():
        leaf["b"] = leaf["b"][..., ::-1].copy()
    jp, pp = jax.tree.map(jnp.asarray, params), bridge.params_from_jax(
        params, pcfg, "cpu")
    jt = [jax.tree.map(jnp.asarray, t) for t in (lora, lora2)]
    pt = [bridge.lora_from_jax(t, "cpu") for t in (lora, lora2)]
    toks = np.random.RandomState(4).randint(0, pcfg.vocab_size,
                                            size=(3, 14)).astype(np.int32)
    from repro.lora.adapters import single_ctx as jax_single_ctx
    jl, _ = jax_forward_train(jp, jnp.asarray(toks), jcfg,
                              jax_single_ctx(jt[0], jcfg))
    pl, paux = forward_train(pp, _t(toks), pcfg, single_ctx(pt[0], pcfg))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    assert float(paux) == 0.0
    ids = np.array([1, 0, 1], np.int32)
    jctx = jax_batched_ctx(jax_stack(jt), jnp.asarray(ids), jcfg)
    pctx = batched_ctx(stack_adapters(pt), _t(ids), pcfg)
    S = 12
    jh, jc, _ = jax_forward_seq(jp, jnp.asarray(toks[:, :S]), jcfg, jctx,
                                jax_init_cache(jcfg, 3, 24))
    ph, pc, _ = forward_seq(pp, _t(toks[:, :S]), pcfg, pctx,
                            init_cache(pcfg, 3, 24, device="cpu"))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **ACT)
    jc = dict(jc, pos=jnp.full((3,), S, jnp.int32))
    pc = dict(pc, pos=torch.full((3,), S, dtype=torch.int32))
    for t in range(2):
        jlog, jc = jax_decode_step(jp, jnp.asarray(toks[:, S + t]), jc, jcfg,
                                   jctx)
        plog, pc = decode_step(pp, _t(toks[:, S + t]), pc, pcfg, pctx)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGITS)
    singles = [forward_train(pp, _t(toks), pcfg, single_ctx(t, pcfg))[0]
               for t in pt]
    batched, _ = forward_train(pp, _t(toks), pcfg, pctx)
    want = torch.stack([singles[i][r] for r, i in enumerate(ids)])
    torch.testing.assert_close(batched, want, rtol=1e-5, atol=1e-5)
