"""The port's moe (deepseek-moe), ssm (mamba2) and hybrid (zamba2) families
(repro_torch.models.{moe,mamba2,model}) against the JAX package on the same
weights, carried over by repro_torch.bridge, on reduced fp32 configs
(conftest.tiny: 2 layers, d=64; MoE at capacity_factor 8, so that nothing is
dropped). Adapters have randomised `b` in both subtrees (``layers`` and the
hybrid's ``shared``): init_lora zeroes it.

Tolerances, fp32 on both sides: activations and recurrent states 1e-5 (the
same ops in another summation order, a few products deep); logits 1e-4 (the
LM head sums over the whole width); the MoE aux loss 1e-5.

Also here: the reference's frozen-row fault of its hybrid ``decode_step``
(ROADMAP §3), recorded deterministically."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny
from repro.lora.adapters import (batched_ctx as jax_batched_ctx, init_lora,
                                 single_ctx as jax_single_ctx,
                                 stack_adapters as jax_stack)
from repro.models import (decode_step as jax_decode_step,
                          forward_prefill_chunk as jax_forward_prefill_chunk,
                          forward_seq as jax_forward_seq,
                          forward_train as jax_forward_train,
                          init_cache as jax_init_cache,
                          init_params as jax_init_params)
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.lora.adapters import batched_ctx, single_ctx, stack_adapters
from repro_torch.models import (decode_step, forward_prefill_chunk,
                                forward_seq, forward_train, init_cache,
                                init_paged_cache, init_params, tree_index)
from repro_torch.models import moe as pmoe

ACT = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ["deepseek-moe-16b", "mamba2-780m", "zamba2-1.2b"]
RECURRENT = ["mamba2-780m", "zamba2-1.2b"]


def _configs(name, **over):
    """(JAX config, port config) of the same reduced fp32 model."""
    jcfg = tiny(name, **over)
    pcfg = pt_reduced(PT_REGISTRY[name], dtype="float32", **over)
    if pcfg.moe is not None:
        pcfg = dataclasses.replace(
            pcfg, moe=dataclasses.replace(pcfg.moe, capacity_factor=8.0))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _adapters(jcfg, n, seed):
    """n JAX adapter trees (numpy leaves) with randomised b everywhere."""
    rs = np.random.RandomState(seed)
    out = []
    for t in range(n):
        tree = _np_tree(init_lora(jax.random.PRNGKey(10 + t), jcfg))
        for sub in tree.values():
            for leaf in sub.values():
                leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.2).astype(np.float32)
        out.append(tree)
    return out


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        jcfg, pcfg = _configs(name)
        jp = _np_tree(jax_init_params(jax.random.PRNGKey(0), jcfg))
        trees = _adapters(jcfg, 2, seed=5)
        _MODELS[name] = dict(
            jcfg=jcfg, pcfg=pcfg, jparams=jax.tree.map(jnp.asarray, jp),
            pparams=bridge.params_from_jax(jp, pcfg, "cpu"),
            jtrees=[jax.tree.map(jnp.asarray, t) for t in trees],
            ptrees=[bridge.lora_from_jax(t, "cpu") for t in trees])
    return _MODELS[name]


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _tokens(V, B, S, seed):
    return np.random.RandomState(seed).randint(1, V, size=(B, S)).astype(np.int32)


def _shapes(tree, prefix=""):
    """{path: shape} of a JAX or port tree (dicts, NamedTuples)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _shapes(v, f"{prefix}/{k}").items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k2: v2 for k, v in zip(tree._fields, tree)
                for k2, v2 in _shapes(v, f"{prefix}/{k}").items()}
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_and_caches_have_the_jax_trees(name):
    """The port's own random init and caches have the JAX package's tree,
    leaf shapes and dtypes (ssm state fp32, conv in the model dtype, K/V
    only for the attention layers: the hybrid's invocations)."""
    m = _model(name)
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    pp = init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(pp) == _shapes(m["jparams"])
    for jc, pc in ((jax_init_cache(jcfg, 3, 32), init_cache(pcfg, 3, 32,
                                                             device="cpu")),):
        assert _shapes(pc) == _shapes(jc)
        for k in jc:
            assert str(pc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
    from repro.models import init_paged_cache as jax_init_paged_cache
    kw = dict(pool_pages=6, page_size=4, max_pages_per_row=3)
    assert (_shapes(init_paged_cache(pcfg, 2, device="cpu", **kw))
            == _shapes(jax_init_paged_cache(jcfg, 2, **kw)))


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_train_logits_and_aux_match_jax(name):
    m = _model(name)
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    toks = _tokens(jcfg.vocab_size, 2, 40, seed=1)
    jl, jaux = jax_forward_train(m["jparams"], jnp.asarray(toks), jcfg,
                                 jax_single_ctx(m["jtrees"][0], jcfg))
    pl, paux = forward_train(m["pparams"], _t(toks), pcfg,
                             single_ctx(m["ptrees"][0], pcfg))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_allclose(float(paux), float(jaux), **ACT)
    assert (float(paux) > 0) == (pcfg.family == "moe")


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_with_cache_then_decode_matches_jax(name):
    """forward_seq with a cache and per-row seq_lens, then two decode steps
    under batched multi-LoRA: hidden states, caches (K/V, ssm, conv) and
    logits against the JAX package, and the decode logits against its
    teacher-forced forward."""
    m = _model(name)
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    B, S, max_len = 3, 12, 32
    toks = _tokens(jcfg.vocab_size, B, S + 2, seed=2)
    lens = np.array([S, S, S], np.int32)
    ids = np.array([0, 1, 1], np.int32)
    jctx = jax_batched_ctx(jax_stack(m["jtrees"]), jnp.asarray(ids), jcfg)
    pctx = batched_ctx(stack_adapters(m["ptrees"]), _t(ids), pcfg)
    jh, jc, _ = jax_forward_seq(m["jparams"], jnp.asarray(toks[:, :S]), jcfg,
                                jctx, jax_init_cache(jcfg, B, max_len),
                                seq_lens=jnp.asarray(lens))
    ph, pc, _ = forward_seq(m["pparams"], _t(toks[:, :S]), pcfg, pctx,
                            init_cache(pcfg, B, max_len, device="cpu"),
                            seq_lens=_t(lens))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **ACT)
    for k in jc:
        if k != "pos":
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                       err_msg=k, **ACT)
    jc = dict(jc, pos=jnp.asarray(lens))
    pc = dict(pc, pos=_t(lens))
    full, _ = jax_forward_train(m["jparams"], jnp.asarray(toks), jcfg, jctx)
    for t in range(2):
        jlog, jc = jax_decode_step(m["jparams"], jnp.asarray(toks[:, S + t]),
                                   jc, jcfg, jctx)
        plog, pc = decode_step(m["pparams"], _t(toks[:, S + t]), pc, pcfg, pctx)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGITS)
        np.testing.assert_allclose(plog.numpy(), np.asarray(full[:, S + t]),
                                   **LOGITS)
    for k in jc:
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]), err_msg=k,
                                   **ACT)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_chunks_equal_whole_prompt_and_jax(name):
    """forward_prefill_chunk chunk by chunk (chunks of the SSD scan's chunk
    size, the last one padded and masked by seq_lens) gives the whole
    prompt's last hidden state and cache state, and the JAX package's
    chunks' values."""
    m = _model(name)
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    C = pcfg.ssm.chunk_size if pcfg.ssm is not None else 8
    L = 2 * C + 5
    toks = _tokens(jcfg.vocab_size, 1, 3 * C, seed=3)
    toks[:, L:] = 0
    max_len = 3 * C
    pctx = single_ctx(m["ptrees"][1], pcfg)
    jctx = jax_single_ctx(m["jtrees"][1], jcfg)
    hw, cw, _ = forward_seq(m["pparams"], _t(toks[:, :L]), pcfg, pctx,
                            init_cache(pcfg, 1, max_len, device="cpu"))
    pc = init_cache(pcfg, 1, max_len, device="cpu")
    jc = jax_init_cache(jcfg, 1, max_len)
    for start in range(0, L, C):
        n = min(C, L - start)
        chunk = toks[:, start:start + C]
        ph, pc = forward_prefill_chunk(m["pparams"], _t(chunk), pcfg, pctx, pc,
                                       start=start, seq_lens=_t([n], np.int32))
        jh, jc = jax_forward_prefill_chunk(m["jparams"], jnp.asarray(chunk),
                                           jcfg, jctx, jc, start=start,
                                           seq_lens=jnp.asarray([n], jnp.int32))
        np.testing.assert_allclose(ph.numpy()[:, :n], np.asarray(jh)[:, :n],
                                   **ACT)
    np.testing.assert_allclose(ph.numpy()[0, n - 1], hw.numpy()[0, L - 1], **ACT)
    for k in ("ssm", "conv"):
        if k in pc:
            np.testing.assert_allclose(pc[k].numpy(), cw[k].numpy(), **ACT)
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]), **ACT)
    if "k" in pc:
        np.testing.assert_allclose(pc["k"].numpy()[:, :, :L],
                                   cw["k"].numpy()[:, :, :L], **ACT)


@pytest.mark.parametrize("name", RECURRENT)
def test_mixed_length_prefill_state_is_exact(name):
    """tests/test_models.py::test_mixed_length_prefill_state_exact on the
    port: a padded mixed-length prefill with seq_lens gives every row the
    ssm/conv state of its unpadded solo prefill; and the JAX package's."""
    m = _model(name)
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    B, S = 3, 24
    lens = np.array([9, 24, 15], np.int32)
    toks = _tokens(jcfg.vocab_size, B, S, seed=4)
    _, pc, _ = forward_seq(m["pparams"], _t(toks), pcfg, None,
                           init_cache(pcfg, B, 32, device="cpu"),
                           seq_lens=_t(lens))
    _, jc, _ = jax_forward_seq(m["jparams"], jnp.asarray(toks), jcfg, None,
                               jax_init_cache(jcfg, B, 32),
                               seq_lens=jnp.asarray(lens))
    for i in range(B):
        _, solo, _ = forward_seq(m["pparams"], _t(toks[i:i + 1, :lens[i]]),
                                 pcfg, None, init_cache(pcfg, 1, 32,
                                                        device="cpu"))
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(pc[k][:, i].numpy(),
                                       solo[k][:, 0].numpy(), err_msg=k, **ACT)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]), **ACT)


@pytest.mark.parametrize("name", FAMILIES)
def test_batched_multi_lora_equals_single(name):
    """tests/test_models.py::test_multi_lora_batched_equals_single on the
    port, the hybrid's shared-block adapters included."""
    m = _model(name)
    pcfg = m["pcfg"]
    toks = _t(_tokens(pcfg.vocab_size, 4, 12, seed=5))
    s1, _ = forward_train(m["pparams"], toks, pcfg, single_ctx(m["ptrees"][0], pcfg))
    s2, _ = forward_train(m["pparams"], toks, pcfg, single_ctx(m["ptrees"][1], pcfg))
    ids = _t([0, 1, 1, 0], np.int32)
    got, _ = forward_train(m["pparams"], toks, pcfg,
                           batched_ctx(stack_adapters(m["ptrees"]), ids, pcfg))
    want = torch.stack([s1[0], s2[1], s2[2], s1[3]])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float((s1 - s2).abs().max()) > 1e-3     # the adapters matter


def _prefilled(m, toks, B, S, port=True):
    cfg = m["pcfg"] if port else m["jcfg"]
    if port:
        _, c, _ = forward_seq(m["pparams"], _t(toks), cfg, None,
                              init_cache(cfg, B, 24, device="cpu"))
        return dict(c, pos=torch.full((B,), S, dtype=torch.int32))
    _, c, _ = jax_forward_seq(m["jparams"], jnp.asarray(toks), cfg, None,
                              jax_init_cache(cfg, B, 24))
    return dict(c, pos=jnp.full((B,), S, jnp.int32))


@pytest.mark.parametrize("name", FAMILIES)
def test_advance_zero_leaves_pos_and_state_unchanged(name):
    """decode_step(advance=[1, 0]) with garbage fed to the frozen row: row
    1's pos, ssm and conv are unchanged, and its resumed logits equal a
    never-frozen run's (tests/test_models.py::test_advance_mask_freezes_rows
    on the port, all three families)."""
    m = _model(name)
    pcfg = m["pcfg"]
    B, S = 2, 9
    toks = _tokens(pcfg.vocab_size, B, S, seed=6)
    cache = _prefilled(m, toks, B, S)
    before = {k: v.clone() for k, v in cache.items()}
    _, cache = decode_step(m["pparams"], _t([toks[0, -1], 7], np.int32), cache,
                           pcfg, advance=_t([1, 0], np.int32))
    assert cache["pos"].tolist() == [S + 1, S]
    for k in ("ssm", "conv"):
        if k in cache:
            assert torch.equal(cache[k][:, 1], before[k][:, 1]), k
            assert not torch.equal(cache[k][:, 0], before[k][:, 0]), k
    real = _t([5, 6], np.int32)
    frozen, _ = decode_step(m["pparams"], real, cache, pcfg,
                            advance=_t([0, 1], np.int32))
    clean, _ = decode_step(m["pparams"], real, _prefilled(m, toks, B, S), pcfg)
    assert float((frozen[1] - clean[1]).abs().max()) < 1e-5


def test_reference_hybrid_decode_advances_frozen_rows_the_port_does_not():
    """ROADMAP §3. The JAX package's decode_step masks a frozen row's
    recurrent state by `advance` in its ssm branch (repro/models/model.py
    :807,814-815) but not in its hybrid branch (:836-840,856): one
    decode_step(advance=[1, 0]) on reduced zamba2 changes row 1's ssm/conv
    there, and nothing in the port. Resumed with a real token, the port's
    logprobs equal a never-frozen run's (atol 1e-5); the JAX package's do
    not. Reduced mamba2 (the ssm branch) is clean in both."""
    for name, jax_faulty in (("zamba2-1.2b", True), ("mamba2-780m", False)):
        m = _model(name)
        jcfg = m["jcfg"]
        B, S = 2, 9
        toks = _tokens(jcfg.vocab_size, B, S, seed=6)
        garbage = np.array([toks[0, -1], 7], np.int32)
        jc0 = _prefilled(m, toks, B, S, port=False)
        _, jc = jax_decode_step(m["jparams"], jnp.asarray(garbage), jc0, jcfg,
                                advance=jnp.asarray([1, 0], jnp.int32))
        jdiff = [float(jnp.abs(jc[k][:, 1] - jc0[k][:, 1]).max())
                 for k in ("ssm", "conv")]
        pc0 = _prefilled(m, toks, B, S)
        before = {k: pc0[k].clone() for k in ("ssm", "conv")}
        _, pc = decode_step(m["pparams"], _t(garbage), pc0, m["pcfg"],
                            advance=_t([1, 0], np.int32))
        assert all(torch.equal(pc[k][:, 1], before[k][:, 1])
                   for k in ("ssm", "conv"))
        real = np.array([5, 6], np.int32)
        jf, _ = jax_decode_step(m["jparams"], jnp.asarray(real), jc, jcfg,
                                advance=jnp.asarray([0, 1], jnp.int32))
        jclean, _ = jax_decode_step(m["jparams"], jnp.asarray(real),
                                    _prefilled(m, toks, B, S, port=False), jcfg)
        pf, _ = decode_step(m["pparams"], _t(real), pc, m["pcfg"],
                            advance=_t([0, 1], np.int32))
        jerr = float(jnp.abs(jax.nn.log_softmax(jf[1])
                             - jax.nn.log_softmax(jclean[1])).max())
        perr = float((torch.log_softmax(pf[1], -1)
                      - torch.log_softmax(_t(np.asarray(jclean[1])), -1))
                     .abs().max())
        assert perr < 1e-5, (name, perr)
        if jax_faulty:
            assert min(jdiff) > 1e-3, jdiff       # both states moved
            assert jerr > 1e-3, jerr
        else:
            assert max(jdiff) == 0.0 and jerr < 1e-5, (jdiff, jerr)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_apply_matches_jax_with_and_without_drops(cf):
    """moe_apply alone against the JAX function on 64 tokens of reduced
    deepseek-moe (4 experts, top 2, one shared expert): dropless at
    capacity_factor 8, and at 0.5 (capacity 24 for 32 assignments an expert
    on average) with drops, which the stable sort must pick as the JAX
    package's argsort does. Output and aux at 1e-5; the port's drop count
    equals the JAX dispatch's."""
    jcfg, pcfg = _configs("deepseek-moe-16b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, capacity_factor=cf))
    m = _model("deepseek-moe-16b")
    jp = jax.tree.map(lambda t: t[0], m["jparams"]["layers"]["moe"])
    pp = tree_index(m["pparams"]["layers"]["moe"], 0)
    x = np.random.RandomState(7).randn(4, 16, jcfg.d_model).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jnp.asarray(x), jp, jcfg)
    pmoe.DROPS.reset(True)
    py, paux = pmoe.moe_apply(_t(x), pp, pcfg)
    dropped = pmoe.DROPS.total()
    pmoe.DROPS.reset(False)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **ACT)
    np.testing.assert_allclose(float(paux), float(jaux), **ACT)
    # the JAX dispatch's drops, recomputed from its own routing
    _, ids, _ = jmoe.route(jnp.asarray(x.reshape(-1, jcfg.d_model)),
                           jp.router, jcfg.moe)
    C = jmoe._expert_capacity(64, jcfg.moe)
    counts = np.bincount(np.asarray(ids).reshape(-1), minlength=4)
    assert dropped == int(np.maximum(counts - C, 0).sum())
    assert (dropped > 0) == (cf < 1)


def test_moe_combine_gives_the_same_bits_on_two_calls():
    m = _model("deepseek-moe-16b")
    pcfg = m["pcfg"]
    toks = _t(_tokens(pcfg.vocab_size, 3, 10, seed=8))
    a, _ = forward_train(m["pparams"], toks, pcfg)
    b, _ = forward_train(m["pparams"], toks, pcfg)
    assert torch.equal(a, b)


def test_moe_decode_frozen_lanes_take_no_capacity():
    """ROADMAP §3. One decode_step of 32 lanes (a fresh cache) of reduced
    deepseek-moe at capacity_factor 0.25: capacity 8 for 16 assignments an
    expert on average, so live tokens are dropped. Every fourth lane is
    frozen (advance 0). The port keeps frozen lanes out of the experts'
    capacity, so its live lanes' logits are bit-equal whatever token the
    frozen lanes hold; the JAX package routes every lane, and its live
    logits move with them. With every lane live the two packages agree
    (logits 1e-4)."""
    m = _model("deepseek-moe-16b")
    jcfg, pcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=0.25)) for c in (m["jcfg"], m["pcfg"]))
    B = 32
    adv = np.ones((B,), np.int32)
    adv[1::4] = 0
    live = adv > 0
    ta = np.random.RandomState(11).randint(1, pcfg.vocab_size, B).astype(np.int32)
    tb = ta.copy()
    tb[~live] = (ta[~live] + 17) % pcfg.vocab_size

    def port(toks, advance=None):
        return decode_step(m["pparams"], _t(toks), init_cache(pcfg, B, 8, device="cpu"),
                           pcfg, advance=None if advance is None else _t(advance))[0]

    def ref(toks, advance=None):
        return np.asarray(jax_decode_step(
            m["jparams"], jnp.asarray(toks), jax_init_cache(jcfg, B, 8), jcfg,
            advance=None if advance is None else jnp.asarray(advance))[0])

    pmoe.DROPS.reset(True)
    pa = port(ta, adv)
    dropped = pmoe.DROPS.total()
    pmoe.DROPS.reset(False)
    assert dropped > 0
    assert torch.equal(pa[live], port(tb, adv)[live])
    assert np.abs(ref(ta, adv)[live] - ref(tb, adv)[live]).max() > 1e-3
    np.testing.assert_allclose(port(ta).numpy(), ref(ta), **LOGITS)


@pytest.mark.parametrize("case", ["ssd_chunked"] + RECURRENT)
def test_ssd_bf16_switch_matches_jax(case, monkeypatch):
    """REPRO_SSD_BF16=1 in both packages (each reads it at call time):
    ssd_chunked alone (2 chunks of 16 and a ragged third, an initial state;
    output and final state at 1e-5), and reduced mamba2 / zamba2
    forward_train (logits at 1e-4: a last-bit difference in an fp32 operand
    can round it to the neighbouring bf16 value, seen up to 1.4e-5). The
    port's unrounded result differs from the JAX package's rounded one by
    well over that tolerance (1.3e-3 to 0.24 seen), so the switch is
    tested."""
    from repro.models.mamba2 import ssd_chunked as jax_ssd
    from repro_torch.models.mamba2 import ssd_chunked

    if case == "ssd_chunked":
        rs = np.random.RandomState(3)
        B, S, H, P, G, N = 2, 40, 4, 16, 1, 16
        args = [rs.randn(B, S, H, P), np.log1p(np.exp(rs.randn(B, S, H))) * 0.5,
                -np.exp(rs.randn(H) * 0.5), rs.randn(B, S, G, N),
                rs.randn(B, S, G, N)]
        args = [a.astype(np.float32) for a in args]
        s0 = rs.randn(B, H, N, P).astype(np.float32)

        def port():
            y, s = ssd_chunked(*map(_t, args), 16, _t(s0))
            return y.numpy(), s.numpy()

        def ref():
            y, s = jax_ssd(*map(jnp.asarray, args), 16, jnp.asarray(s0))
            return np.asarray(y), np.asarray(s)
        tol = ACT
    else:
        m = _model(case)
        toks = _tokens(m["jcfg"].vocab_size, 2, 40, seed=1)

        def port():
            return (forward_train(m["pparams"], _t(toks), m["pcfg"],
                                  single_ctx(m["ptrees"][0], m["pcfg"]))[0].numpy(),)

        def ref():
            return (np.asarray(jax_forward_train(
                m["jparams"], jnp.asarray(toks), m["jcfg"],
                jax_single_ctx(m["jtrees"][0], m["jcfg"]))[0]),)
        tol = LOGITS
    monkeypatch.setenv("REPRO_SSD_BF16", "1")
    want = ref()
    for got, w in zip(port(), want):
        np.testing.assert_allclose(got, w, **tol)
    monkeypatch.setenv("REPRO_SSD_BF16", "0")
    assert np.abs(port()[0] - want[0]).max() > 10 * tol["atol"]
