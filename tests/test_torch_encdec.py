"""The port's encdec family (seamless-m4t-large-v2's backbone: a
bidirectional encoder over stub frontend embeddings, a decoder with a
cross-attention after each self-attention) and two-level remat, against the
JAX package on the same weights, carried over by repro_torch.bridge, on the
reduced fp32 config (conftest.tiny: 2 encoder and 2 decoder layers, d=64,
4 heads of 16, 2 KV heads, gelu). Inputs are numpy arrays from a seed:
tokens, the frontend's frame embeddings (8 frames) and adapters with a
randomised `b` (init_lora zeroes it).

Tolerances, fp32 on both sides (tests/test_torch_families.py's and
tests/test_torch_train.py's): activations and caches 1e-5; logits 1e-4;
losses and metrics 1e-5 (absolute 1e-6); adapters after one AdamW step
1e-6 where the step is determined (the clipped gradient above 100 eps);
moments and adapter gradients 1e-4 of each leaf's largest element.

Also here: the engines' refusal of encdec, and the JAX engine's failure on
it (ROADMAP §3)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny, tiny_lm
from repro.lora.adapters import (batched_ctx as jax_batched_ctx, init_lora,
                                 single_ctx as jax_single_ctx,
                                 stack_adapters as jax_stack)
from repro.models import (decode_step as jax_decode_step,
                          forward_seq as jax_forward_seq,
                          forward_train as jax_forward_train,
                          init_cache as jax_init_cache,
                          init_paged_cache as jax_init_paged_cache,
                          init_params as jax_init_params)
from repro.train import optimizer as jopt
from repro.train.train_step import (TrainConfig as JTrainConfig,
                                    init_opt_state as jax_init_opt,
                                    make_train_step as jax_make_train_step)
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.lora.adapters import batched_ctx, single_ctx, stack_adapters
from repro_torch.models import (decode_step, forward_prefill_chunk,
                                forward_seq, forward_train, init_cache,
                                init_paged_cache, init_params, tree_leaves,
                                tree_unflatten)
from repro_torch.models import model as pmodel
from repro_torch.train import optimizer as popt
from repro_torch.train.train_step import (TrainConfig, init_opt_state,
                                          make_train_step)

ARCH = "seamless-m4t-large-v2"
ACT = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
LR = 3e-3
STEP_TOL = 1e-6
S_ENC = 8


def _configs(**over):
    jcfg = tiny(ARCH, **over)
    pcfg = pt_reduced(PT_REGISTRY[ARCH], dtype="float32", **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    assert pcfg.family == "encdec" and pcfg.encoder_layers == 2
    return jcfg, pcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _adapters(jcfg, n, seed):
    """n JAX adapter trees (numpy leaves) with randomised b."""
    rs = np.random.RandomState(seed)
    out = []
    for t in range(n):
        tree = _np_tree(init_lora(jax.random.PRNGKey(10 + t), jcfg))
        for sub in tree.values():
            for leaf in sub.values():
                leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.2).astype(np.float32)
        out.append(tree)
    return out


_MODEL = {}


def _model():
    if not _MODEL:
        jcfg, pcfg = _configs()
        jp = _np_tree(jax_init_params(jax.random.PRNGKey(0), jcfg))
        trees = _adapters(jcfg, 2, seed=5)
        _MODEL.update(
            jcfg=jcfg, pcfg=pcfg, np_params=jp,
            jparams=jax.tree.map(jnp.asarray, jp),
            pparams=bridge.params_from_jax(jp, pcfg, "cpu"), np_trees=trees,
            jtrees=[jax.tree.map(jnp.asarray, t) for t in trees],
            ptrees=[bridge.lora_from_jax(t, "cpu") for t in trees])
    return _MODEL


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _tokens(V, B, S, seed):
    return np.random.RandomState(seed).randint(1, V, size=(B, S)).astype(np.int32)


def _enc(B, d, seed):
    return np.random.RandomState(seed).randn(B, S_ENC, d).astype(np.float32)


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


def test_init_params_and_caches_have_the_jax_trees():
    """The port's own init has the JAX tree (the encoder stack, the decoder
    layers' lnx/xattn), shapes and dtypes; init_cache adds xk/xv of
    enc_len frames; the paged pool refuses encdec in both packages."""
    m = _model()
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    pp = init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat(m["jparams"]).items()}
    got = {k: (v.shape, str(v.dtype)) for k, v in
           _flat(bridge.to_numpy(pp)).items()}
    assert got == want
    assert "/encoder/attn/wq" in got and "/layers/xattn/wk" in got
    jc = jax_init_cache(jcfg, 3, 32, enc_len=S_ENC)
    pc = init_cache(pcfg, 3, 32, enc_len=S_ENC, device="cpu")
    assert set(pc) == set(jc) == {"pos", "k", "v", "xk", "xv"}
    for k in jc:
        assert tuple(pc[k].shape) == jc[k].shape, k
        assert str(pc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
    kw = dict(pool_pages=6, page_size=4, max_pages_per_row=3)
    with pytest.raises(ValueError, match="encdec"):
        jax_init_paged_cache(jcfg, 2, **kw)
    with pytest.raises(ValueError, match="encdec"):
        init_paged_cache(pcfg, 2, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="encdec"):
        forward_prefill_chunk(m["pparams"], _t(_tokens(64, 1, 4, 0)), pcfg,
                              None, pc)
    with pytest.raises(ValueError, match="enc_embeds"):
        forward_train(m["pparams"], _t(_tokens(64, 1, 4, 0)), pcfg)


@pytest.mark.parametrize("S", [13, 32])
def test_forward_train_matches_jax(S):
    """forward_train with enc_embeds under one task's adapters: logits; with
    q_chunk 4 at S=32 the decoder's self- and cross-attention and the
    encoder (8 frames) run query-chunked."""
    m = _model()
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    toks = _tokens(jcfg.vocab_size, 2, S, seed=1)
    enc = _enc(2, jcfg.d_model, seed=2)
    q = 4 if S == 32 else 512
    jl, jaux = jax_forward_train(m["jparams"], jnp.asarray(toks), jcfg,
                                 jax_single_ctx(m["jtrees"][0], jcfg),
                                 enc_embeds=jnp.asarray(enc), q_chunk=q)
    pl, paux = forward_train(m["pparams"], _t(toks), pcfg,
                             single_ctx(m["ptrees"][0], pcfg),
                             enc_embeds=_t(enc), q_chunk=q)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    assert float(paux) == float(jaux) == 0.0


def test_prefill_with_cache_then_decode_matches_jax():
    """forward_seq with a cache (xk/xv and k/v written) under batched
    multi-LoRA over 2 adapters, then two decode steps: hidden states,
    every cache entry and the logits against the JAX package, and the
    decode logits against its teacher-forced forward."""
    m = _model()
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    B, S, max_len = 3, 12, 32
    toks = _tokens(jcfg.vocab_size, B, S + 2, seed=2)
    enc = _enc(B, jcfg.d_model, seed=3)
    ids = np.array([0, 1, 1], np.int32)
    jctx = jax_batched_ctx(jax_stack(m["jtrees"]), jnp.asarray(ids), jcfg)
    pctx = batched_ctx(stack_adapters(m["ptrees"]), _t(ids), pcfg)
    jh, jc, _ = jax_forward_seq(m["jparams"], jnp.asarray(toks[:, :S]), jcfg,
                                jctx, jax_init_cache(jcfg, B, max_len,
                                                     enc_len=S_ENC),
                                enc_embeds=jnp.asarray(enc))
    pc0 = init_cache(pcfg, B, max_len, enc_len=S_ENC, device="cpu")
    ph, pc, _ = forward_seq(m["pparams"], _t(toks[:, :S]), pcfg, pctx, pc0,
                            enc_embeds=_t(enc))
    assert pc is pc0                              # written in place
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **ACT)
    for k in ("k", "v", "xk", "xv"):
        assert float(np.abs(np.asarray(jc[k])).max()) > 0, k
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **ACT)
    jc = dict(jc, pos=jnp.full((B,), S, jnp.int32))
    pc = dict(pc, pos=torch.full((B,), S, dtype=torch.int32))
    full, _ = jax_forward_train(m["jparams"], jnp.asarray(toks), jcfg, jctx,
                                enc_embeds=jnp.asarray(enc))
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KVH,window,cap", [(4, 4, 0, 0.0), (4, 2, 0, 0.0),
                                              (8, 2, 5, 30.0)])
def test_attention_decode_plain_matches_jax(H, KVH, window, cap, dtype):
    """attention_decode_plain (the cross-attention's decode path) against
    the JAX package's attention_decode with use_kernel=False on the same
    numpy inputs: rep 1 and 2 and 4, a window, a softcap, positions from 1
    to the cache's length. fp32 within 1e-5; bf16 within 1e-2 (one ulp
    of the outputs: both sides round the scores and the softmax to bf16,
    in a different summation order)."""
    from repro.configs import get_config as jax_get_config
    from repro.models.attention import attention_decode as jax_attention_decode
    from repro_torch.configs import get_config
    from repro_torch.models.attention import attention_decode_plain
    B, S, hd = 3, 11, 16
    rng = np.random.default_rng(7 + H + KVH + window)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KVH, hd)).astype(np.float32) for _ in "kv")
    pos = np.array([1, 6, S], np.int32)
    jcfg = dataclasses.replace(jax_get_config(ARCH), attn_softcap=cap or None)
    pcfg = dataclasses.replace(get_config(ARCH), attn_softcap=cap or None)
    jd, pd = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_attention_decode(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                jnp.asarray(pos), jcfg, window=window)
    got = attention_decode_plain(*(torch.from_numpy(a).to(pd) for a in (q, k, v)),
                                 torch.from_numpy(pos), pcfg, window=window)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert got.dtype == pd and got.shape == (B, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=tol,
                               atol=tol)


def test_batched_multi_lora_equals_single():
    """Rows under a batched ctx equal each row under its own adapter alone,
    with the encoder memory of its own frames."""
    m = _model()
    pcfg = m["pcfg"]
    toks = _t(_tokens(pcfg.vocab_size, 4, 12, seed=4))
    enc = _t(_enc(4, pcfg.d_model, seed=5))
    ids = [0, 1, 1, 0]
    singles = [forward_train(m["pparams"], toks, pcfg,
                             single_ctx(m["ptrees"][a], pcfg),
                             enc_embeds=enc)[0] for a in (0, 1)]
    got, _ = forward_train(m["pparams"], toks, pcfg,
                           batched_ctx(stack_adapters(m["ptrees"]),
                                       _t(ids, np.int32), pcfg),
                           enc_embeds=enc)
    want = torch.stack([singles[a][i] for i, a in enumerate(ids)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _batch(V, d, seed=3):
    """4 rows in 2 GRPO groups of 2, S=12, prompts of 3-5 tokens, 8 frames
    each."""
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(0, V, size=(4, 12)).astype(np.int32),
            "prompt_lens": np.array([3, 4, 5, 3], np.int32),
            "total_lens": np.array([12, 9, 11, 7], np.int32),
            "rewards": np.array([1.0, 0.0, 0.25, 0.75], np.float32),
            "enc_embeds": rs.randn(4, S_ENC, d).astype(np.float32)}


@pytest.mark.parametrize("case", ["default", "kl_ent", "accum2"])
def test_lora_grpo_step_matches_jax(case):
    """make_train_step with enc_embeds in the batch (the reference policy of
    the KL term takes them too; two micro-batches slice them with the rows):
    loss, metrics, the adapters after one AdamW step and the moments."""
    m = _model()
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    kw = dict(group_size=2)
    if case == "kl_ent":
        kw.update(kl_coef=0.05, ent_coef=0.01)
    if case == "accum2":
        kw.update(accum_steps=2)
    tc_j = JTrainConfig(adamw=jopt.AdamWConfig(lr=LR), **kw)
    tc_p = TrainConfig(adamw=popt.AdamWConfig(lr=LR), **kw)
    batch = _batch(jcfg.vocab_size, jcfg.d_model)
    lora = m["np_trees"][0]
    jlora = jax.tree.map(jnp.asarray, lora)
    jnew, jst, jm = jax.jit(jax_make_train_step(jcfg, tc_j))(
        m["jparams"], jlora, jax_init_opt(jcfg, tc_j, m["jparams"], jlora),
        jax.tree.map(jnp.asarray, batch))
    plora = bridge.lora_from_jax(lora, "cpu")
    pnew, pst, pm = make_train_step(pcfg, tc_p)(
        m["pparams"], plora, init_opt_state(pcfg, tc_p, m["pparams"], plora),
        {k: _t(v) for k, v in batch.items()})
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                   rtol=1e-5, atol=1e-6)
    assert float(pm["grad_norm"]) > 0
    got, want, mom = (_flat(bridge.to_numpy(pnew)), _flat(jnew), _flat(jst["m"]))
    assert got.keys() == want.keys() == mom.keys()
    for k in want:
        err = np.abs(got[k] - want[k])
        sure = np.abs(10 * mom[k]) > 100 * 1e-8
        assert sure.mean() > 0.5, k               # every adapter is trained
        assert err[sure].max(initial=0) <= STEP_TOL, (k, err[sure].max())
        assert err.max() <= LR, (k, err.max())
    for name in ("m", "v"):
        pg, jg = _flat(bridge.to_numpy(pst[name])), _flat(jst[name])
        for k in jg:
            e = np.abs(pg[k] - jg[k]).max()
            assert e <= 1e-4 * np.abs(jg[k]).max(), (name, k, e)


def _loss_and_grads_port(pcfg, params, tree, toks, tgt_w, enc):
    """sum(log_softmax(logits) * tgt_w) and its gradient in every adapter
    leaf."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    logits, _ = forward_train(params, toks, pcfg,
                              single_ctx(tree_unflatten(tree, leaves), pcfg),
                              enc_embeds=enc)
    loss = (torch.log_softmax(logits, dim=-1) * tgt_w).sum()
    grads = torch.autograd.grad(loss, leaves)
    return logits.detach(), tree_unflatten(tree, list(grads))


def _loss_and_grads_jax(jcfg, params, tree, toks, tgt_w, enc):
    def loss(t):
        logits, _ = jax_forward_train(params, toks, jcfg,
                                      jax_single_ctx(t, jcfg), enc_embeds=enc)
        return (jax.nn.log_softmax(logits, axis=-1) * tgt_w).sum(), logits
    (_, logits), g = jax.value_and_grad(loss, has_aux=True)(tree)
    return logits, g


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("blk", [1, 2])
@pytest.mark.parametrize("arch", [ARCH, "granite-3-2b"])
def test_remat_block_matches_plain_and_jax(arch, blk, remat, monkeypatch):
    """Two-level remat (cfg.remat_block) on the decoder stack: logits and
    adapter gradients equal those of remat_block 0 (the same ops, only
    recomputed: to the bit) and the JAX package's at the same remat_block;
    the forward checkpoints L/blk blocks, each holding its layers'
    checkpoints under cfg.remat, and the encoder keeps per-layer ones."""
    jcfg = dataclasses.replace(tiny(arch), remat=remat, remat_block=blk)
    pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY[arch], dtype="float32"),
                               remat=remat, remat_block=blk)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    jp = _np_tree(jax_init_params(jax.random.PRNGKey(0), jcfg))
    tree_np = _adapters(jcfg, 1, seed=7)[0]
    pparams = bridge.params_from_jax(jp, pcfg, "cpu")
    ptree = bridge.lora_from_jax(tree_np, "cpu")
    toks = _tokens(jcfg.vocab_size, 2, 12, seed=8)
    tgt_w = np.random.RandomState(9).rand(2, 12, jcfg.vocab_size).astype(np.float32)
    enc = _enc(2, jcfg.d_model, seed=10) if arch == ARCH else None
    penc = None if enc is None else _t(enc)

    calls = []
    real = pmodel.checkpoint

    def counting(fn, *a, **k):
        calls.append(fn.__name__)
        return real(fn, *a, **k)
    monkeypatch.setattr(pmodel, "checkpoint", counting)
    with torch.enable_grad():          # the forward's checkpoints only
        forward_train(pparams, _t(toks), pcfg, single_ctx(
            tree_unflatten(ptree, [t.detach().requires_grad_(True)
                                   for t in tree_leaves(ptree)]), pcfg),
            enc_embeds=penc)
    monkeypatch.setattr(pmodel, "checkpoint", real)
    L = pcfg.num_layers
    n_enc = pcfg.encoder_layers if arch == ARCH and remat else 0
    assert calls == (["_dense_block_seq"] * n_enc
                     + (["block"] + ["_attn_layer_seq"] * blk * remat)
                     * (L // blk)), calls
    pl, pg = _loss_and_grads_port(pcfg, pparams, ptree, _t(toks), _t(tgt_w),
                                  penc)

    base = dataclasses.replace(pcfg, remat_block=0)
    bl, bg = _loss_and_grads_port(base, pparams, ptree, _t(toks), _t(tgt_w),
                                  penc)
    assert torch.equal(pl, bl)
    for a, b in zip(tree_leaves(pg), tree_leaves(bg)):
        assert torch.equal(a, b)
    jl, jg = _loss_and_grads_jax(jcfg, jax.tree.map(jnp.asarray, jp),
                                 jax.tree.map(jnp.asarray, tree_np),
                                 jnp.asarray(toks), jnp.asarray(tgt_w),
                                 None if enc is None else jnp.asarray(enc))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    got, want = _flat(bridge.to_numpy(pg)), _flat(jg)
    assert got.keys() == want.keys()
    for k in want:
        e = np.abs(got[k] - want[k]).max()
        assert e <= 1e-4 * np.abs(want[k]).max(), (k, e)


def test_remat_block_needs_grad_no_cache_and_a_divisor():
    """Two-level remat applies only where it can save memory: with grad on,
    no cache, and remat_block dividing the depth; else the plain loop."""
    m = _model()
    pcfg = m["pcfg"]
    toks = _t(_tokens(pcfg.vocab_size, 1, 6, seed=11))
    enc = _t(_enc(1, pcfg.d_model, seed=12))
    calls = []
    real = pmodel.checkpoint
    try:
        pmodel.checkpoint = lambda fn, *a, **k: calls.append(fn) or real(fn, *a, **k)
        for cfg, grad, cache in (
                (dataclasses.replace(pcfg, remat_block=2), False, None),
                (dataclasses.replace(pcfg, remat_block=3), True, None),
                (dataclasses.replace(pcfg, remat_block=2), True,
                 init_cache(pcfg, 1, 8, enc_len=S_ENC, device="cpu"))):
            with torch.set_grad_enabled(grad):
                forward_seq(m["pparams"], toks, cfg, None, cache,
                            enc_embeds=enc)
    finally:
        pmodel.checkpoint = real
    assert calls == []


def test_untied_head_lies_in_a_row_padded_buffer():
    """An untied head whose V is not a multiple of 8 (seamless's 256206;
    here 1003) is the [:, :V] view of a [d, 1008] buffer, from init_params
    and from the bridge, with the JAX package's values: forward_train gives
    the bits of a contiguous head, within LOGITS of the JAX package's, and
    to_numpy gives the JAX head back bit for bit. A head with V a multiple
    of 8 stays contiguous."""
    jcfg, pcfg = _configs(vocab_size=1003)
    own = init_params(pcfg, torch.Generator().manual_seed(0), "cpu")["lm_head"]
    assert own.shape == (pcfg.d_model, 1003) and own.stride() == (1008, 1)
    assert own.untyped_storage().nbytes() == pcfg.d_model * 1008 * 4
    jp = _np_tree(jax_init_params(jax.random.PRNGKey(0), jcfg))
    pp = bridge.params_from_jax(jp, pcfg, "cpu")
    assert pp["lm_head"].stride() == (1008, 1)
    np.testing.assert_array_equal(bridge.to_numpy(pp)["lm_head"], jp["lm_head"])
    toks = _t(_tokens(1003, 2, 12, seed=13))
    enc = _enc(2, pcfg.d_model, seed=14)
    got, _ = forward_train(pp, toks, pcfg, enc_embeds=_t(enc))
    flat = dict(pp, lm_head=pp["lm_head"].contiguous())
    assert torch.equal(got, forward_train(flat, toks, pcfg, enc_embeds=_t(enc))[0])
    want, _ = jax_forward_train(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(toks.numpy()), jcfg,
                                enc_embeds=jnp.asarray(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    _, pcfg8 = _configs()
    head8 = init_params(pcfg8, torch.Generator().manual_seed(0), "cpu")["lm_head"]
    assert head8.is_contiguous() and pcfg8.vocab_size % 8 == 0


# ---------------------------------------------------------------------------
# the engines refuse encdec; the JAX engine fails on it
# ---------------------------------------------------------------------------

def _lm_configs():
    jcfg = tiny_lm(ARCH)
    pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY[ARCH], dtype="float32"),
                               vocab_size=jcfg.vocab_size)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


@pytest.mark.parametrize("engine", ["round", "continuous", "disagg",
                                    "runtime"])
def test_engines_refuse_encdec(engine):
    """RolloutEngine, ContinuousRolloutEngine (the prefill workers with it)
    and the runtime that builds them raise NotImplementedError naming the
    reason and the step builders that serve the family."""
    from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
    from repro_torch.rollout.engine import (ContinuousRolloutEngine,
                                            RolloutEngine)
    _, pcfg = _lm_configs()
    params = init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    make = {"round": lambda: RolloutEngine(pcfg, params, device="cpu"),
            "continuous": lambda: ContinuousRolloutEngine(pcfg, params,
                                                          device="cpu"),
            "disagg": lambda: ContinuousRolloutEngine(
                pcfg, params, disagg_prefill=True, prefill_workers=2,
                device="cpu"),
            "runtime": lambda: MARLaaSRuntime(pcfg, params,
                                              RuntimeConfig(device="cpu"))}
    with pytest.raises(NotImplementedError,
                       match="enc_embeds.*launch.specs.build_prefill_step"):
        make[engine]()


def test_serve_cli_refuses_encdec():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="encdec"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="encdec"):
        serve.main(["--arch", ARCH])           # before any card is asked for


def test_reference_engine_cannot_serve_encdec():
    """ROADMAP §3: the JAX RolloutEngine allocates encdec's cross-attention
    cache but passes no enc_embeds, so its first prefill encodes None."""
    from repro.envs.tasks import make_env
    from repro.rollout.engine import RolloutEngine as JaxEngine, RolloutRequest
    jcfg, _ = _lm_configs()
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    env = make_env("gsm8k")
    prompt, truth = env.sample_prompt(__import__("random").Random(0))
    reqs = [RolloutRequest("t0", 0, prompt, truth, env, max_new_tokens=2)]
    eng = JaxEngine(jcfg, params, max_len=32, seed=0)
    with pytest.raises(AttributeError, match="NoneType"):
        eng.generate(reqs, [init_lora(jax.random.PRNGKey(1), jcfg)])
