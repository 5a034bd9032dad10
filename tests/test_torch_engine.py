"""The port's RolloutEngine.generate against the JAX engine: the same bridged
fp32 weights and randomised-b adapters, the same requests and seed. Token
streams and loss masks must be identical and logprobs agree within 1e-4 (a
sampled token could only flip if two perturbed scores came within ~1e-6 of
each other, which these sizes do not produce)."""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny, tiny_lm
from repro.data import tokenizer as tok
from repro.envs.tasks import make_env
from repro.lora.adapters import init_lora
from repro.models import init_params
from repro.rollout.engine import RolloutEngine, RolloutRequest
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.envs.base import Env as PtEnv
from repro_torch.envs.tasks import make_env as pt_make_env
from repro_torch.launch import serve
from repro_torch.rollout.engine import (RolloutEngine as PtEngine,
                                        RolloutRequest as PtRequest)


def _setup(jcfg, pcfg, n_tenants=2, seed=7):
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(seed)
    trees = []
    for t in range(n_tenants):
        tree = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(1 + t), jcfg))
        for leaf in tree["layers"].values():
            leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.3).astype(np.float32)
        trees.append(tree)
    jparams = jax.tree.map(jnp.asarray, params)
    jtrees = [jax.tree.map(jnp.asarray, t) for t in trees]
    pparams = bridge.params_from_jax(params, pcfg, "cpu")
    ptrees = [bridge.lora_from_jax(t, "cpu") for t in trees]
    return jparams, jtrees, pparams, ptrees


def _requests(n, n_tenants):
    """The same gsm8k requests for both engines (each its own env object)."""
    jenv, penv = make_env("gsm8k"), pt_make_env("gsm8k")
    rj, rp = random.Random(0), random.Random(0)
    jreqs, preqs = [], []
    for i in range(n):
        pj, tj = jenv.sample_prompt(rj)
        pp, tp = penv.sample_prompt(rp)
        assert (pj, tj) == (pp, tp)
        kw = dict(max_new_tokens=4 + 3 * (i % 3), temperature=0.9)
        jreqs.append(RolloutRequest(f"t{i % n_tenants}", i % n_tenants, pj, tj,
                                    jenv, **kw))
        preqs.append(PtRequest(f"t{i % n_tenants}", i % n_tenants, pp, tp, penv,
                               **kw))
    return jreqs, preqs


def _assert_same(res_j, res_p):
    assert len(res_j) == len(res_p)
    for a, b in zip(res_j, res_p):
        assert a["tokens"] == b["tokens"]
        assert a["gen_loss_mask"] == b["gen_loss_mask"]
        assert a["finish_reason"] == b["finish_reason"]
        np.testing.assert_allclose(b["gen_logprobs"], a["gen_logprobs"],
                                   rtol=1e-4, atol=1e-4)


def _port_cfg(name, lm_vocab):
    cfg = pt_reduced(PT_REGISTRY[name], dtype="float32")
    if lm_vocab:
        cfg = dataclasses.replace(cfg, vocab_size=tok.VOCAB_SIZE)
    return cfg


def test_generate_matches_jax_engine():
    jcfg, pcfg = tiny_lm("granite-3-2b"), _port_cfg("granite-3-2b", True)
    jparams, jtrees, pparams, ptrees = _setup(jcfg, pcfg)
    jreqs, preqs = _requests(6, 2)
    res_j, st_j = RolloutEngine(jcfg, jparams, max_len=64, seed=0).generate(
        jreqs, jtrees)
    res_p, st_p = PtEngine(pcfg, pparams, max_len=64, seed=0,
                           device="cpu").generate(preqs, ptrees)
    _assert_same(res_j, res_p)
    assert (st_p.decode_steps, st_p.prefill_tokens, st_p.tokens_generated,
            st_p.sampled_tokens) == (st_j.decode_steps, st_j.prefill_tokens,
                                     st_j.tokens_generated, st_j.sampled_tokens)


def _no_eos_torch(eng):
    """The port's counterpart of test_continuous._no_eos: remap sampled EOS to
    a plain char token so row lengths are exactly their budgets."""
    eng._build(1)
    step, first_fn = eng._step_fn, eng._first_fn

    def wrap_step(*a):
        out = step(*a)
        return (torch.where(out[0] == tok.EOS, 10, out[0]),) + tuple(out[1:])

    def wrap_first(*a):
        s, lp = first_fn(*a)
        return torch.where(s == tok.EOS, 10, s), lp

    eng._step_fn, eng._first_fn = wrap_step, wrap_first


def test_forced_tool_tokens_do_not_consume_budget():
    """tests/test_continuous.py's forced-tool-token scenario replayed against
    the port: a 20-token tool response is force-fed after a CALL, and the row
    still samples its full budget of 4 tokens after ENDRESP."""
    jcfg, pcfg = tiny_lm("granite-3-2b"), _port_cfg("granite-3-2b", True)
    _, _, pparams, ptrees = _setup(jcfg, pcfg, n_tenants=1)

    class LongToolEnv(PtEnv):
        name = "longtool"
        is_agentic = True
        env_latency_mean = 0.0

        def sample_prompt(self, rng):
            return [tok.BOS] + tok.encode("abc?"), "42"

        def verify(self, truth, completion_ids):
            return 0.0

        def tool_call(self, query_ids, truth=None):
            return tok.encode("0123456789" * 2)      # 20-token response

    env = LongToolEnv()
    eng = PtEngine(pcfg, pparams, max_len=96, seed=0, device="cpu")
    _no_eos_torch(eng)
    orig_step = eng._step_fn
    count = {"n": 0}

    def forced_call_step(*args):
        nxt, lp, cache = orig_step(*args)
        count["n"] += 1
        if count["n"] == 1:                  # first decode step emits CALL
            nxt = torch.full_like(nxt, tok.CALL)
        return nxt, lp, cache

    eng._step_fn = forced_call_step
    reqs = [PtRequest("lt", 0, [tok.BOS] + tok.encode("abc?"), "42", env,
                      max_new_tokens=4)]
    res, _ = eng.generate(reqs, ptrees)
    mask = res[0]["gen_loss_mask"]
    toks = res[0]["tokens"][res[0]["prompt_len"]:]
    assert tok.RESP in toks and tok.ENDRESP in toks
    # full budget of SAMPLED tokens, despite 22 forced tokens in between
    assert sum(1 for m in mask if m == 1.0) == 4
    # and the sampled answer tokens sit AFTER the tool response
    end = toks.index(tok.ENDRESP)
    assert len(toks) > end + 1
    assert all(m == 1.0 for m in mask[end + 1:])
    assert toks[end - 20:end] == tok.encode("0123456789" * 2)


def test_generate_qwen3_reduced_end_to_end():
    """qwen3-0.6b reduced (qk-norm, theta=1e6, V=256) through generate on
    both engines, 3 tenants: identical streams, well-formed results."""
    jcfg, pcfg = tiny("qwen3-0.6b"), _port_cfg("qwen3-0.6b", False)
    jparams, jtrees, pparams, ptrees = _setup(jcfg, pcfg, n_tenants=3)
    jreqs, preqs = _requests(6, 3)
    res_j, _ = RolloutEngine(jcfg, jparams, max_len=48, seed=3).generate(
        jreqs, jtrees)
    res_p, stats = PtEngine(pcfg, pparams, max_len=48, seed=3,
                            device="cpu").generate(preqs, ptrees)
    _assert_same(res_j, res_p)
    for r, q in zip(res_p, preqs):
        gen = r["tokens"][r["prompt_len"]:]
        assert 1 <= len(gen) <= q.max_new_tokens
        assert all(0 <= t < pcfg.vocab_size for t in gen)
        assert all(np.isfinite(lp) and lp <= 0 for lp in r["gen_logprobs"])
    assert stats.decode_steps == max(len(r["tokens"]) - r["prompt_len"]
                                     for r in res_p) - 1


def test_serve_cli_reduced_cpu(capsys):
    """python -m repro_torch.launch.serve --reduced --device cpu."""
    results, stats = serve.main(["--reduced", "--device", "cpu", "--tenants",
                                 "2", "--per-tenant", "2"])
    assert len(results) == 4 and stats.decode_steps >= 1
    assert "served 4 requests for 2 tenants" in capsys.readouterr().out
    assert serve.render([tok.BOS, 8, 151935]) == "<bos>0<151935>"


def test_cuda_entry_points_refuse_without_a_card():
    """Entry points default to the card and raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _port_cfg("granite-3-2b", True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PtEngine(cfg, {}, max_len=16)
