"""The port's dense model (repro_torch.models, repro_torch.lora) against the
JAX package on the same weights, carried over by repro_torch.bridge, on
three reduced fp32 configs: tiny_lm() (granite), qwen3-0.6b (qk-norm,
theta=1e6) and gemma2-27b (score and logit softcaps, sliding window).
Adapters have randomised `b` (init_lora zeroes it, which would make every
LoRA delta 0 and prove nothing).

Tolerances: activations at 1e-5 — both sides compute the same fp32 ops and
differ only in the summation order of their matmuls (~1e-7 relative per
product, a few products deep); logits at 1e-4 — the LM head sums over the
whole width and the logits are larger."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny, tiny_lm
from repro.lora import multilora as jml
from repro.lora.adapters import (batched_ctx as jax_batched_ctx, init_lora,
                                 stack_adapters as jax_stack)
from repro.models import attention as jatt
from repro.models import common as jcommon
from repro.models import (decode_step as jax_decode_step,
                          forward_seq as jax_forward_seq,
                          init_cache as jax_init_cache,
                          init_params as jax_init_params)
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.data import tokenizer as pt_tok
from repro_torch.lora import multilora as pml
from repro_torch.lora.adapters import batched_ctx, stack_adapters
from repro_torch.models import attention as patt
from repro_torch.models import common as pcommon
from repro_torch.models import decode_step, forward_seq, init_cache

ACT = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
CONFIGS = ["granite-3-2b", "qwen3-0.6b", "gemma2-27b"]


def _configs(name):
    """(JAX config, port config) of the same reduced fp32 model."""
    if name == "granite-3-2b":
        jcfg = tiny_lm(name)
        pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY[name], dtype="float32"),
                                   vocab_size=pt_tok.VOCAB_SIZE)
    else:
        jcfg = tiny(name)
        pcfg = pt_reduced(PT_REGISTRY[name], dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _adapters(jcfg, n, seed):
    """n JAX adapter trees (numpy leaves) with randomised b."""
    rs = np.random.RandomState(seed)
    out = []
    for t in range(n):
        tree = _np_tree(init_lora(jax.random.PRNGKey(10 + t), jcfg))
        for leaf in tree["layers"].values():
            leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.2).astype(np.float32)
        out.append(tree)
    return out


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    jcfg, pcfg = _configs(request.param)
    jp = _np_tree(jax_init_params(jax.random.PRNGKey(0), jcfg))
    trees = _adapters(jcfg, 2, seed=5)
    jstack = jax_stack([jax.tree.map(jnp.asarray, t) for t in trees])
    pstack = stack_adapters([bridge.lora_from_jax(t, "cpu") for t in trees])
    return dict(jcfg=jcfg, pcfg=pcfg, jparams=jax.tree.map(jnp.asarray, jp),
                pparams=bridge.params_from_jax(jp, pcfg, "cpu"),
                jstack=jstack, pstack=pstack)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def test_rmsnorm_and_rope():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 3, 16).astype(np.float32)
    w = rs.randn(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        pcommon.rmsnorm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **ACT)
    positions = np.arange(5)[None, :] + np.array([[0], [7]])
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            pcommon.apply_rope(_t(x), _t(positions), theta).numpy(),
            np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                                          theta)), **ACT)


def test_qkv_with_batched_lora(model):
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    rs = np.random.RandomState(1)
    B, S = 3, 6
    x = rs.randn(B, S, jcfg.d_model).astype(np.float32)
    ids = np.array([0, 1, 1], np.int32)
    positions = np.arange(S)[None, :]
    jlp = jax.tree.map(lambda t: t[0], model["jparams"]["layers"])
    jl = jax_batched_ctx(model["jstack"], jnp.asarray(ids), jcfg).at_layer(
        jax.tree.map(lambda t: t[0], model["jstack"]["layers"]))
    want = jatt.qkv(jnp.asarray(x), jlp["attn"], jcfg, jnp.asarray(positions), jl)
    plp = model["pparams"]["layers"]["attn"]
    pattn = type(plp)(*(None if v is None else v[0] for v in plp))
    pl = batched_ctx(model["pstack"], _t(ids), pcfg).at_layer(
        {k: {n: v[0] for n, v in d.items()}
         for k, d in model["pstack"]["layers"].items()})
    got = patt.qkv(_t(x), pattn, pcfg, _t(positions), pl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ACT)


@pytest.mark.parametrize("window", [0, 5])
def test_attention_decode(model, window):
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    rs = np.random.RandomState(2)
    B, Smax = 3, 24
    q = rs.randn(B, jcfg.num_heads, jcfg.head_dim).astype(np.float32)
    ck = rs.randn(B, Smax, jcfg.num_kv_heads, jcfg.head_dim).astype(np.float32)
    cv = rs.randn(B, Smax, jcfg.num_kv_heads, jcfg.head_dim).astype(np.float32)
    pos = np.array([1, 11, 24], np.int32)
    want = jatt.attention_decode(*(jnp.asarray(v) for v in (q, ck, cv, pos)),
                                 jcfg, window=window)
    got = patt.attention_decode(*(_t(v) for v in (q, ck, cv, pos)), pcfg,
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_multi_lora_delta(model, use_kernel):
    """The port's delta against the JAX oracle and its Pallas SGMV route."""
    jcfg = model["jcfg"]
    rs = np.random.RandomState(3)
    leaf = model["jstack"]["layers"]["attn_q"]
    a, b = np.asarray(leaf["a"][1]), np.asarray(leaf["b"][1])
    ids = np.array([1, 0, 1, 1], np.int32)
    for shape in ((4, jcfg.d_model), (4, 5, jcfg.d_model)):
        x = rs.randn(*shape).astype(np.float32)
        want = jml.multi_lora_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(ids), jcfg.lora.scaling,
                                    use_kernel=use_kernel)
        got = pml.multi_lora_delta(_t(x), _t(a), _t(b), _t(ids), jcfg.lora.scaling)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


def _prefill(model, tokens, ids, max_len):
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    jl = jax_batched_ctx(model["jstack"], jnp.asarray(ids), jcfg)
    jh, jcache, _ = jax_forward_seq(model["jparams"], jnp.asarray(tokens), jcfg,
                                    jl, jax_init_cache(jcfg, tokens.shape[0],
                                                       max_len))
    pl = batched_ctx(model["pstack"], _t(ids), pcfg)
    ph, pcache, _ = forward_seq(model["pparams"], _t(tokens), pcfg, pl,
                                init_cache(pcfg, tokens.shape[0], max_len,
                                           device="cpu"))
    return (jh, jcache), (ph, pcache)


def test_forward_seq_with_cache(model):
    rs = np.random.RandomState(4)
    B, S, max_len = 3, 8, 16
    tokens = rs.randint(0, model["jcfg"].vocab_size, size=(B, S)).astype(np.int32)
    ids = np.array([0, 1, 0], np.int32)
    (jh, jcache), (ph, pcache) = _prefill(model, tokens, ids, max_len)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **ACT)
    for name in ("k", "v"):
        np.testing.assert_allclose(pcache[name].numpy(), np.asarray(jcache[name]),
                                   **ACT)


def test_decode_step_mixed_advance(model):
    """One decode step after a prefill, with one row frozen (advance 0):
    same logits, same cache, and pos moves only where advance is 1."""
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    rs = np.random.RandomState(5)
    B, S, max_len = 3, 8, 16
    tokens = rs.randint(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    ids = np.array([1, 0, 1], np.int32)
    lens = np.array([8, 5, 3], np.int32)
    (_, jcache), (_, pcache) = _prefill(model, tokens, ids, max_len)
    jcache = dict(jcache, pos=jnp.asarray(lens))
    pcache = dict(pcache, pos=_t(lens))
    new = rs.randint(0, jcfg.vocab_size, size=(B,)).astype(np.int32)
    adv = np.array([1, 0, 1], np.int32)
    jlog, jc = jax_decode_step(model["jparams"], jnp.asarray(new), jcache, jcfg,
                               jax_batched_ctx(model["jstack"], jnp.asarray(ids),
                                               jcfg),
                               advance=jnp.asarray(adv))
    plog, pc = decode_step(model["pparams"], _t(new), pcache, pcfg,
                           batched_ctx(model["pstack"], _t(ids), pcfg),
                           advance=_t(adv))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGITS)
    np.testing.assert_array_equal(pc["pos"].numpy(), lens + adv)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(pc[name].numpy(), np.asarray(jc[name]), **ACT)


def test_decode_write_past_the_cache_end_writes_nothing():
    """The port writes the one decode position in place; the JAX package
    merges it with a where over the whole cache. Same values, including a
    row whose pos is past the cache end (nothing written)."""
    from repro.models.model import _write_kv as jax_write_kv
    from repro_torch.models.model import _write_kv
    rs = np.random.RandomState(6)
    ck, cv = (rs.randn(3, 4, 2, 8).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(3, 1, 2, 8).astype(np.float32) for _ in range(2))
    pos = np.array([4, 2, 0], np.int32)
    jk, jv = jax_write_kv(*(jnp.asarray(a) for a in (ck, cv, k, v, pos)))
    tk, tv = _t(ck), _t(cv)
    _write_kv(tk, tv, _t(k), _t(v), _t(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[0], ck[0])


def test_bridge_keeps_bf16_bits_and_tree():
    jcfg = dataclasses.replace(tiny_lm("granite-3-2b"), dtype="bfloat16")
    pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY["granite-3-2b"]),
                               vocab_size=pt_tok.VOCAB_SIZE)
    jp = _np_tree(jax_init_params(jax.random.PRNGKey(0), jcfg))
    pp = bridge.params_from_jax(jp, pcfg, "cpu")
    assert pp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pp["embed"].view(torch.int16).numpy(),
                                  jp["embed"].view(np.int16))
    attn = pp["layers"]["attn"]
    assert type(attn).__name__ == "AttnParams" and attn.bq is None
    assert tuple(attn.wq.shape) == jp["layers"]["attn"].wq.shape
    with pytest.raises(ValueError):
        bridge.params_from_jax(jp, dataclasses.replace(pcfg, vocab_size=99), "cpu")
