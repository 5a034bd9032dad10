"""The port's trainer (rl/grpo.py, train/optimizer.py, train/train_step.py,
train/sft.py, rollout to_trajectory_batch) against the JAX package on the
same numpy inputs and the same bridged fp32 weights.

Tolerances, fp32 on both sides:
- losses and metrics 1e-5: the same ops, other summation orders;
- gradients 1e-5 of the largest element, and 1e-4 through a whole model
  (the backward of a few layers sums in another order at every product);
- parameters after an AdamW step: 1e-6 absolute (0.03% of the step's
  size lr=3e-3) where the gradient is above 100 eps (see _assert_step);
- optimizer moments (m = 0.1 g, v = 0.001 g^2 after one step) at 1e-4 of
  each leaf's largest element, as the gradients through a model."""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny, tiny_lm
from repro.envs.tasks import make_env
from repro.lora.adapters import init_lora
from repro.models import forward_seq as jax_forward_seq
from repro.models import init_params
from repro.rl import grpo as jgrpo
from repro.rollout.engine import to_trajectory_batch as jax_to_tb
from repro.train import optimizer as jopt
from repro.train.sft import make_sft_step as jax_make_sft_step
from repro.train.train_step import (TrainConfig as JTrainConfig,
                                    init_opt_state as jax_init_opt,
                                    make_train_step as jax_make_train_step)
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.data import tokenizer as pt_tok
from repro_torch.envs.tasks import make_env as pt_make_env
from repro_torch.lora.adapters import single_ctx
from repro_torch.models import forward_seq, forward_train, tree_leaves, tree_map
from repro_torch.rl import grpo as pgrpo
from repro_torch.rollout.engine import to_trajectory_batch
from repro_torch.train import optimizer as popt
from repro_torch.train.sft import make_sft_step, sft_init
from repro_torch.train.train_step import (TrainConfig, batch_from_trajectory,
                                          init_opt_state, make_train_step)

TIGHT = dict(rtol=1e-5, atol=1e-5)
LR = 3e-3
STEP_TOL = 1e-6          # updated parameters, where the step is determined


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


def _assert_trees(port_tree, jax_tree, *, scaled=None, **tol):
    """Leaf by leaf; `scaled`: max abs error at most this share of the
    leaf's largest element."""
    got, want = _flat(bridge.to_numpy(port_tree)), _flat(jax_tree)
    assert got.keys() == want.keys()
    for k in want:
        if scaled is not None:
            err = np.abs(got[k] - want[k]).max()
            assert err <= scaled * np.abs(want[k]).max(), (k, err)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _assert_step(port_tree, jax_tree, jax_m):
    """Parameters after one AdamW step, compared where the step is
    determined: elements whose clipped gradient (10 m, from the JAX
    optimizer state) is above 100 eps move by about lr * sign(g), and must
    agree to STEP_TOL; an element with |g| near eps moves by g / (|g| +
    eps) of a step, which a tiny difference in g changes, so it is only
    held to one step."""
    got, want = _flat(bridge.to_numpy(port_tree)), _flat(jax_tree)
    m = _flat(jax_m)
    assert got.keys() == want.keys() == m.keys()
    for k in want:
        err = np.abs(got[k] - want[k])
        sure = np.abs(10 * m[k]) > 100 * 1e-8
        assert sure.mean() > 0.5, k
        assert err[sure].max(initial=0) <= STEP_TOL, (k, err[sure].max())
        assert err.max() <= LR, (k, err.max())


# ---------------------------------------------------------------------------
# rl/grpo.py
# ---------------------------------------------------------------------------

def test_group_advantages_incl_a_constant_group():
    r = np.array([1, 0, 0, 1, 0.5, 0.5, 0.5, 0.5, 3, -1, 2, 0], np.float32)
    for G in (2, 4):
        np.testing.assert_allclose(
            pgrpo.group_advantages(_t(r), G).numpy(),
            np.asarray(jgrpo.group_advantages(jnp.asarray(r), G)), **TIGHT)
    assert not pgrpo.group_advantages(_t(r), 4)[4:8].any()   # constant group


def _grpo_case(kind, seed=0):
    rs = np.random.RandomState(seed)
    R, S = 4, 6
    new = (rs.randn(R, S) * 0.3 - 2).astype(np.float32)
    mask = (rs.rand(R, S) > 0.3).astype(np.float32)
    adv = rs.randn(R).astype(np.float32)
    ent = rs.rand(R, S).astype(np.float32)
    old = None if kind == "tie" else (new + rs.randn(R, S) * 0.4).astype(np.float32)
    ref = (new + rs.randn(R, S) * 0.2).astype(np.float32)
    beh = (new + rs.randn(R, S) * 0.5).astype(np.float32)
    kw = dict(clip_eps=0.2, kl_coef=0.0, ent_coef=0.0, is_cap=0.0)
    if kind == "kl":
        kw.update(kl_coef=0.1, ent_coef=0.01)
    if kind == "is_cap":
        kw.update(is_cap=1.5)
    return new, old, adv, mask, ref, ent, beh, kw


@pytest.mark.parametrize("kind", ["tie", "clip", "kl", "is_cap"])
def test_grpo_loss_values_and_grads(kind):
    """'tie' is on-policy (old = stop_gradient(new), ratio = 1), where
    min(unclipped, clipped) ties and both frameworks split the gradient
    between the two branches."""
    new, old, adv, mask, ref, ent, beh, kw = _grpo_case(kind)

    def jloss(n, e):
        o = jax.lax.stop_gradient(n) if old is None else jnp.asarray(old)
        out = jgrpo.grpo_loss(n, o, jnp.asarray(adv), jnp.asarray(mask),
                              jnp.asarray(ref), entropy=e,
                              behavior_logprobs=jnp.asarray(beh), **kw)
        return out.loss, out
    (jl, jout), (jg_new, jg_ent) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(new), jnp.asarray(ent))

    pn = _t(new).requires_grad_(True)
    pe = _t(ent).requires_grad_(True)
    po = pn.detach() if old is None else _t(old)
    out = pgrpo.grpo_loss(pn, po, _t(adv), _t(mask), _t(ref), entropy=pe,
                          behavior_logprobs=_t(beh), **kw)
    out.loss.backward()
    for name in out._fields:
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), err_msg=name,
                                   **TIGHT)
    np.testing.assert_allclose(pn.grad.numpy(), np.asarray(jg_new), **TIGHT)
    np.testing.assert_allclose(pe.grad.numpy(), np.asarray(jg_ent), **TIGHT)


# ---------------------------------------------------------------------------
# train/optimizer.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(), dict(grad_clip=0.0), dict(weight_decay=0.1, warmup_steps=2),
    dict(grad_clip=0.05)])
def test_adamw_and_clipping_match_jax(cfg):
    acfg_j = jopt.AdamWConfig(lr=LR, **cfg)
    acfg_p = popt.AdamWConfig(lr=LR, **cfg)
    rs = np.random.RandomState(1)
    params = {"x": {"a": rs.randn(3, 4).astype(np.float32)},
              "y": rs.randn(5).astype(np.float32)}
    jp, js = jax.tree.map(jnp.asarray, params), jopt.adamw_init(params)
    pp = tree_map(_t, params)
    ps = popt.adamw_init(pp)
    for step in range(3):
        grads = jax.tree.map(lambda a: (rs.randn(*a.shape) * 0.3).astype(np.float32),
                             params)
        jp, js, jn = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js,
                                       acfg_j)
        pp, ps, pn = popt.adamw_update(pp, tree_map(_t, grads), ps, acfg_p)
        np.testing.assert_allclose(float(pn), float(jn), **TIGHT)
        _assert_trees(pp, jp, rtol=1e-6, atol=1e-7)
        _assert_trees(ps["m"], js["m"], rtol=1e-5, atol=1e-8)
        _assert_trees(ps["v"], js["v"], rtol=1e-5, atol=1e-9)
        assert ps["step"].dtype == torch.int32 and int(ps["step"]) == step + 1
    n, gn = popt.clip_by_global_norm(tree_map(_t, params), 0.5)
    jn_tree, jgn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, params), 0.5)
    np.testing.assert_allclose(float(gn), float(jgn), **TIGHT)
    _assert_trees(n, jn_tree, **TIGHT)


# ---------------------------------------------------------------------------
# train/train_step.py
# ---------------------------------------------------------------------------

def _pair(name):
    """(JAX cfg, port cfg) of the same reduced fp32 model."""
    if name == "granite-3-2b":
        jcfg = tiny_lm(name)
        pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY[name], dtype="float32"),
                                   vocab_size=pt_tok.VOCAB_SIZE)
    else:
        jcfg = tiny(name)
        pcfg = pt_reduced(PT_REGISTRY[name], dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        jcfg, pcfg = _pair(name)
        params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
        lora = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(1), jcfg))
        rs = np.random.RandomState(2)
        for leaf in lora["layers"].values():
            leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.2).astype(np.float32)
        _MODELS[name] = (jcfg, pcfg, params, lora)
    return _MODELS[name]


def _batch(V, *, loss_mask=False, behavior=False, seed=3):
    """4 rows in 2 GRPO groups of 2, S=12, prompts of 3-5 tokens."""
    rs = np.random.RandomState(seed)
    R, S = 4, 12
    b = {"tokens": rs.randint(0, V, size=(R, S)).astype(np.int32),
         "prompt_lens": np.array([3, 4, 5, 3], np.int32),
         "total_lens": np.array([12, 9, 11, 7], np.int32),
         "rewards": np.array([1.0, 0.0, 0.25, 0.75], np.float32)}
    if loss_mask:
        b["loss_mask"] = (rs.rand(R, S) > 0.25).astype(np.float32)
    if behavior:
        b["behavior_logprobs"] = (-3 + rs.randn(R, S - 1)).astype(np.float32)
    return b


CASES = {
    "default": dict(),
    "accum2": dict(accum_steps=2),
    "kl_ent": dict(kl_coef=0.05, ent_coef=0.01),
    "is_cap": dict(is_cap=1.5, recompute_old=False),
    "loss_mask": dict(),
    "full": dict(trainable="full"),
    "kernel": dict(),
}


@pytest.mark.parametrize("model,case", [
    ("granite-3-2b", c) for c in CASES] + [
    ("qwen3-0.6b", "default"), ("qwen3-0.6b", "kl_ent"),
    ("qwen3-0.6b", "kernel")])
def test_train_step_matches_jax(model, case):
    jcfg, pcfg, params, lora = _model(model)
    kw = dict(group_size=2, **CASES[case])
    tc_j = JTrainConfig(adamw=jopt.AdamWConfig(lr=LR), **kw)
    tc_p = TrainConfig(adamw=popt.AdamWConfig(lr=LR),
                       use_logprob_kernel=case == "kernel", **kw)
    batch = _batch(jcfg.vocab_size, loss_mask=case == "loss_mask",
                   behavior=case == "is_cap")

    jparams = jax.tree.map(jnp.asarray, params)
    jlora = jax.tree.map(jnp.asarray, lora)
    jstep = jax.jit(jax_make_train_step(jcfg, tc_j))
    jnew, jopt_state, jm = jstep(jparams, jlora, jax_init_opt(jcfg, tc_j, jparams,
                                                              jlora),
                                 jax.tree.map(jnp.asarray, batch))

    pparams = bridge.params_from_jax(params, pcfg, "cpu")
    plora = bridge.lora_from_jax(lora, "cpu")
    step = make_train_step(pcfg, tc_p)
    pnew, popt_state, pm = step(pparams, plora,
                                init_opt_state(pcfg, tc_p, pparams, plora),
                                {k: _t(v) for k, v in batch.items()})
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                   rtol=1e-5, atol=1e-6)
    assert float(pm["grad_norm"]) > 0
    _assert_step(pnew, jnew, jopt_state["m"])
    _assert_trees(popt_state["m"], jopt_state["m"], scaled=1e-4)
    _assert_trees(popt_state["v"], jopt_state["v"], scaled=1e-4)
    assert int(popt_state["step"]) == int(jopt_state["step"]) == 1


@pytest.mark.parametrize("trainable", ["lora", "full"])
def test_sft_step_matches_jax(trainable):
    jcfg, pcfg, params, lora = _model("granite-3-2b")
    batch = _batch(jcfg.vocab_size, seed=5)
    jtree = jax.tree.map(jnp.asarray, lora if trainable == "lora" else params)
    jstep = jax.jit(jax_make_sft_step(jcfg, jopt.AdamWConfig(lr=LR), trainable))
    jnew, jstate, jm = jstep(jax.tree.map(jnp.asarray, params), jtree,
                             jopt.adamw_init(jtree),
                             jax.tree.map(jnp.asarray, batch))
    pparams = bridge.params_from_jax(params, pcfg, "cpu")
    ptree = bridge.lora_from_jax(lora, "cpu") if trainable == "lora" else pparams
    step = make_sft_step(pcfg, popt.AdamWConfig(lr=LR), trainable)
    pnew, _, pm = step(pparams, ptree, sft_init(ptree),
                       {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6)
    _assert_step(pnew, jnew, jstate["m"])


def test_remat_on_and_off_give_the_same_values_and_grads():
    """forward_seq checkpoints every layer under cfg.remat with grad on (as
    the JAX scan body): the loss and the adapter grads do not change, and
    the JAX forward agrees."""
    jcfg, pcfg, params, lora = _model("qwen3-0.6b")
    tokens = _t(_batch(pcfg.vocab_size)["tokens"])
    pparams = bridge.params_from_jax(params, pcfg, "cpu")
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(pcfg, remat=remat)
        plora = tree_map(lambda t: t.clone().requires_grad_(True),
                         bridge.lora_from_jax(lora, "cpu"))
        logits, _ = forward_train(pparams, tokens, cfg, single_ctx(plora, cfg))
        logits.square().mean().backward()
        out.append((logits.detach(), [g.grad for g in tree_leaves(plora)]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    from repro.lora.adapters import single_ctx as jax_single_ctx
    jh, _, _ = jax_forward_seq(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(tokens.numpy()), jcfg,
                               jax_single_ctx(jax.tree.map(jnp.asarray, lora), jcfg))
    ph, _, _ = forward_seq(pparams, tokens, pcfg,
                           single_ctx(bridge.lora_from_jax(lora, "cpu"), pcfg))
    np.testing.assert_allclose(ph.detach().numpy(), np.asarray(jh), **TIGHT)


# ---------------------------------------------------------------------------
# rollout/engine.py::to_trajectory_batch, train_step.batch_from_trajectory
# ---------------------------------------------------------------------------

def _results(env):
    """generate()-style result dicts for two tasks, with a tool-response
    (loss-masked) stretch and a correct answer."""
    rng = random.Random(0)
    out = []
    for i in range(5):
        prompt, truth = env.sample_prompt(rng)
        gen = [5 + i, 9, 11] if i != 2 else [7] * 9
        if i == 1:
            from repro_torch.data import tokenizer as tk
            gen = tk.encode(str(truth)) + [tk.EOS]
        out.append({"task_id": f"t{i % 2}", "prompt_len": len(prompt),
                    "tokens": list(prompt) + gen,
                    "gen_logprobs": [-0.5 - 0.1 * k for k in range(len(gen))],
                    "gen_loss_mask": [0.0 if 2 <= k < 5 else 1.0
                                      for k in range(len(gen))],
                    "truth": truth, "env": env, "finish_reason": "budget"})
    return out


@pytest.mark.parametrize("pad_to", [None, 48])
def test_to_trajectory_batch_matches_jax(pad_to):
    jres, pres = _results(make_env("gsm8k")), _results(pt_make_env("gsm8k"))
    for tid in ("t0", "t1"):
        j = jax_to_tb(jres, tid, 3, 1, pad_to=pad_to)
        p = to_trajectory_batch(pres, tid, 3, 1, pad_to=pad_to)
        for f in ("tokens", "prompt_lens", "total_lens", "rewards",
                  "behavior_logprobs"):
            np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
            assert getattr(p, f).dtype == getattr(j, f).dtype
        np.testing.assert_array_equal(p.meta["loss_mask"], j.meta["loss_mask"])
        assert p.meta["finish_reasons"] == j.meta["finish_reasons"]
        assert (p.version, p.group_size, p.num_rows) == (j.version, j.group_size,
                                                         j.num_rows)
    assert to_trajectory_batch(pres, "t1", 0, 1).rewards.max() == 1.0


def test_batch_from_trajectory_keys():
    tb = to_trajectory_batch(_results(pt_make_env("gsm8k")), "t0", 0, 1)
    b = batch_from_trajectory(tb, TrainConfig(group_size=1), "cpu")
    assert set(b) == {"tokens", "prompt_lens", "total_lens", "rewards",
                      "loss_mask"}
    assert b["tokens"].dtype == torch.int32 and b["rewards"].dtype == torch.float32
    b = batch_from_trajectory(tb, TrainConfig(group_size=1, is_cap=2.0), "cpu")
    assert b["behavior_logprobs"].shape == (3, tb.tokens.shape[1] - 1)


def test_to_numpy_keeps_bf16_bits_and_int32_step():
    t = torch.randn(3, 5).to(torch.bfloat16)
    state = popt.adamw_init({"w": t.float()})
    out = bridge.to_numpy({"w": t, "opt": state})
    assert out["w"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(out["w"].view(np.int16), t.view(torch.int16).numpy())
    assert out["opt"]["step"].dtype == np.int32
    back = bridge.lora_from_jax(out, "cpu")
    assert torch.equal(back["w"], t)
