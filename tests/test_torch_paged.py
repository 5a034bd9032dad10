"""The paged KV cache of the port against the JAX package, on the CPU.

(a) ``paged_gqa_decode``'s CPU path (its plain version) against the JAX
    Pallas kernel in interpret mode and ``repro.kernels.ref``'s oracle,
    across ``tests/test_kernels.py``'s sweep, with sentinel table entries,
    aliased tables and bf16; with an identity table it equals the port's
    contiguous ``gqa_decode``. Tolerances as in the JAX tests: 2e-5 fp32,
    3e-2 bf16.
(b) ``init_paged_cache`` lays out the JAX package's keys, shapes and
    sentinel; ``decode_step`` on a paged cache equals JAX's on the same
    cache (fp32 logits, 1e-5) and the port's dense ``decode_step`` on the
    gathered cache, and writes the same pages.
(c) The copies of ``PagePool``, ``SnapshotStore`` and
    ``SlotScheduler``/``LengthPredictor`` behave as the reference classes
    on the same operation sequences (``tests/test_paged_kv.py``'s allocator
    property, basics and snapshot budget, and the scheduler's pop order).

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 3)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

try:        # the property test skips without hypothesis; the rest still run
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False
requires_hypothesis = pytest.mark.skipif(not HAVE_HYPOTHESIS,
                                         reason="hypothesis not installed")

from conftest import tiny, tiny_lm
from repro.kernels import ref as jref
from repro.kernels.paged_decode import paged_gqa_decode as jax_paged
from repro.lora.adapters import batched_ctx as jbatched, init_lora
from repro.lora.adapters import stack_adapters as jstack
from repro.models import decode_step as jdecode_step
from repro.models import init_paged_cache as jinit_paged_cache
from repro.models import init_params
from repro.rollout import kvcache as jkv
from repro.rollout import scheduler as jsched
from repro_torch import bridge
from repro_torch import models as M
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.data import tokenizer as pt_tok
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as paged_mod
from repro_torch.kernels.ref import gqa_decode_ref
from repro_torch.lora.adapters import batched_ctx, stack_adapters
from repro_torch.rollout import kvcache as pkv
from repro_torch.rollout import scheduler as psched


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pool(rs, B, n_pg, page, KVH, hd, pos):
    """Random pool of B*n_pg + 3 pages (+ scratch) handed out as a random
    permutation; each row's entries past ceil(pos/page) are the sentinel."""
    P = B * n_pg + 3
    kp = rs.randn(P + 1, page, KVH, hd).astype(np.float32)
    vp = rs.randn(P + 1, page, KVH, hd).astype(np.float32)
    tbl = rs.permutation(P)[:B * n_pg].reshape(B, n_pg).astype(np.int32)
    live = -(-pos // page)
    tbl[np.arange(n_pg)[None, :] >= live[:, None]] = P
    return kp, vp, tbl


# ===========================================================================
# (a) the kernel's CPU path
# ===========================================================================

@pytest.mark.parametrize("B,H,KVH,hd,n_pg,page", [
    (2, 4, 2, 16, 4, 16), (3, 8, 2, 32, 2, 64), (2, 4, 4, 16, 8, 8),
    (1, 12, 2, 16, 3, 32), (2, 16, 8, 64, 2, 128),
])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 24)])
def test_paged_gqa_decode_sweep(B, H, KVH, hd, n_pg, page, softcap, window):
    rs = np.random.RandomState(B * n_pg * page + H)
    q = rs.randn(B, H, hd).astype(np.float32)
    pos = rs.randint(1, n_pg * page + 1, size=B).astype(np.int32)
    kp, vp, tbl = _pool(rs, B, n_pg, page, KVH, hd, pos)
    got = ops.paged_gqa_decode(*(torch.from_numpy(v)
                                 for v in (q, kp, vp, tbl, pos)),
                               softcap=softcap, window=window)
    jin = [jnp.asarray(v) for v in (q, kp, vp, tbl, pos)]
    for want in (jax_paged(*jin, softcap=softcap, window=window),
                 jref.paged_gqa_decode_ref(*jin, softcap=softcap,
                                           window=window)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_paged_gqa_decode_bf16():
    rs = np.random.RandomState(1)
    q = rs.randn(2, 4, 16).astype(np.float32)
    pos = np.array([13, 64], np.int32)
    kp, vp, tbl = _pool(rs, 2, 4, 16, 2, 16, pos)
    tq, tk, tv = (torch.from_numpy(v).to(torch.bfloat16) for v in (q, kp, vp))
    got = ops.paged_gqa_decode(tq, tk, tv, torch.from_numpy(tbl),
                               torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(v, jnp.bfloat16) for v in (q, kp, vp))
    for want in (jax_paged(jq, jk, jv, jnp.asarray(tbl), jnp.asarray(pos)),
                 jref.paged_gqa_decode_ref(jq, jk, jv, jnp.asarray(tbl),
                                           jnp.asarray(pos))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2, atol=3e-2)


def test_paged_gqa_decode_aliased_block_tables():
    """Rows whose tables name the SAME prompt pages read the same values as
    rows with private copies of them, each masked at its own depth
    (``tests/test_kernels.py``'s COW-sharing case)."""
    rs = np.random.RandomState(2)
    B, H, KVH, hd, n_pg, page = 4, 8, 2, 32, 4, 16
    q = rs.randn(B, H, hd).astype(np.float32)
    P = 2 + 2 * B
    kp = rs.randn(P + 1, page, KVH, hd).astype(np.float32)
    vp = rs.randn(P + 1, page, KVH, hd).astype(np.float32)
    tbl = np.zeros((B, n_pg), np.int32)
    tbl[:, :2] = [0, 1]                       # all rows share pages 0, 1
    for b in range(B):
        tbl[b, 2:] = [2 + 2 * b, 3 + 2 * b]   # private tails
    pos = np.array([page + 3, 2 * page, 3 * page + 5, 4 * page - 1], np.int32)
    t = [torch.from_numpy(v) for v in (q, kp, vp, tbl, pos)]
    got = ops.paged_gqa_decode(*t)
    jin = [jnp.asarray(v) for v in (q, kp, vp, tbl, pos)]
    for want in (jax_paged(*jin), jref.paged_gqa_decode_ref(*jin)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    # private copies of the shared pages give the same bits
    kp2 = np.concatenate([kp, np.repeat(kp[[0, 1]], B, 0)])
    vp2 = np.concatenate([vp, np.repeat(vp[[0, 1]], B, 0)])
    tbl2 = tbl.copy()
    for b in range(B):
        tbl2[b, :2] = [P + 1 + b, P + 1 + B + b]
    got2 = ops.paged_gqa_decode(*(torch.from_numpy(v)
                                  for v in (q, kp2, vp2, tbl2, pos)))
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_paged_gqa_decode_identity_table_equals_contiguous():
    """Pages laid out in row order through an identity table reproduce the
    contiguous attention exactly (the port's and the JAX package's)."""
    rs = np.random.RandomState(3)
    B, H, KVH, hd, n_pg, page = 2, 8, 2, 32, 4, 32
    q = rs.randn(B, H, hd).astype(np.float32)
    ck = rs.randn(B, n_pg * page, KVH, hd).astype(np.float32)
    cv = rs.randn(B, n_pg * page, KVH, hd).astype(np.float32)
    pos = np.array([37, 128], np.int32)
    zero = np.zeros((1, page, KVH, hd), np.float32)
    kp = np.concatenate([ck.reshape(B * n_pg, page, KVH, hd), zero])
    vp = np.concatenate([cv.reshape(B * n_pg, page, KVH, hd), zero])
    tbl = np.arange(B * n_pg, dtype=np.int32).reshape(B, n_pg)
    got = ops.paged_gqa_decode(*(torch.from_numpy(v)
                                 for v in (q, kp, vp, tbl, pos)))
    dense = gqa_decode_ref(*(torch.from_numpy(v) for v in (q, ck, cv, pos)))
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    want = jref.gqa_decode_ref(*(jnp.asarray(v) for v in (q, ck, cv, pos)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_cpu_wrapper_does_not_count_launches():
    n = paged_mod.LAUNCHES.n
    ops.paged_gqa_decode(torch.zeros(1, 2, 16), torch.zeros(3, 4, 1, 16),
                         torch.zeros(3, 4, 1, 16),
                         torch.zeros(1, 2, dtype=torch.int32),
                         torch.ones(1, dtype=torch.int32))
    assert paged_mod.LAUNCHES.n == n


# ===========================================================================
# (b) init_paged_cache and the paged decode_step
# ===========================================================================

def _port_cfg(name, lm_vocab):
    import dataclasses
    cfg = pt_reduced(PT_REGISTRY[name], dtype="float32")
    if lm_vocab:
        cfg = dataclasses.replace(cfg, vocab_size=pt_tok.VOCAB_SIZE)
    return cfg


def test_init_paged_cache_matches_jax_layout():
    jcfg, pcfg = tiny("qwen3-0.6b"), _port_cfg("qwen3-0.6b", False)
    jc = jinit_paged_cache(jcfg, 3, pool_pages=10, page_size=8,
                           max_pages_per_row=5)
    pc = M.init_paged_cache(pcfg, 3, pool_pages=10, page_size=8,
                            max_pages_per_row=5, device="cpu")
    assert set(jc) == set(pc) == {"pos", "tbl", "kp", "vp"}
    for k in jc:
        assert tuple(jc[k].shape) == tuple(pc[k].shape), k
        np.testing.assert_array_equal(np.asarray(jc[k], np.float32),
                                      pc[k].float().numpy())
    assert int(pc["tbl"][0, 0]) == 10                # the sentinel


@pytest.mark.parametrize("name,lm_vocab", [("qwen3-0.6b", False),
                                           ("granite-3-2b", True)])
def test_paged_decode_step_matches_jax_and_dense(name, lm_vocab):
    """One decode step over a shuffled pool with randomised adapters, one
    frozen row (advance 0) and one empty lane (all-sentinel table): logits
    equal JAX's decode_step on the same cache and the port's dense
    decode_step on the gathered cache; the written pages equal JAX's."""
    jcfg = tiny_lm(name) if lm_vocab else tiny(name)
    pcfg = _port_cfg(name, lm_vocab)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(5)
    trees = []
    for t in range(2):
        tree = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(1 + t),
                                                  jcfg))
        for leaf in tree["layers"].values():
            leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.3).astype(np.float32)
        trees.append(tree)
    B, page, n_pg, P = 4, 8, 4, 20
    L, KVH, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    pos = np.array([5, 17, 30, 3], np.int32)
    kp = (rs.randn(L, P + 1, page, KVH, hd) * 0.5).astype(np.float32)
    vp = (rs.randn(L, P + 1, page, KVH, hd) * 0.5).astype(np.float32)
    tbl = rs.permutation(P)[:B * n_pg].reshape(B, n_pg).astype(np.int32)
    live = pos // page + 1                  # pages covering [0, pos]
    tbl[np.arange(n_pg)[None, :] >= live[:, None]] = P
    tbl[3] = P                                           # empty lane
    toks = rs.randint(0, jcfg.vocab_size, size=B).astype(np.int32)
    ids = np.array([0, 1, 1, 0], np.int32)
    adv = np.array([1, 0, 1, 1], np.int32)               # row 1 frozen

    jcache = {"pos": jnp.asarray(pos), "tbl": jnp.asarray(tbl),
              "kp": jnp.asarray(kp), "vp": jnp.asarray(vp)}
    jl, jnew = jdecode_step(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks), jcache, jcfg,
        jbatched(jstack([jax.tree.map(jnp.asarray, t) for t in trees]),
                 jnp.asarray(ids), jcfg), advance=jnp.asarray(adv))

    pparams = bridge.params_from_jax(params, pcfg, "cpu")
    stacked = stack_adapters([bridge.lora_from_jax(t, "cpu") for t in trees])
    lora = batched_ctx(stacked, torch.from_numpy(ids), pcfg)
    pcache = {"pos": torch.from_numpy(pos), "tbl": torch.from_numpy(tbl),
              "kp": torch.from_numpy(kp.copy()),
              "vp": torch.from_numpy(vp.copy())}
    with torch.inference_mode():
        pl, pnew = M.decode_step(pparams, torch.from_numpy(toks), pcache,
                                 pcfg, lora, advance=torch.from_numpy(adv))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pnew["pos"].numpy(), np.asarray(jnew["pos"]))
    real = np.arange(P)                  # the scratch page may differ
    for k in ("kp", "vp"):
        np.testing.assert_allclose(pnew[k].numpy()[:, real],
                                   np.asarray(jnew[k])[:, real], rtol=1e-5,
                                   atol=1e-5)

    # the dense cache holding the same values gives the same logits
    ck = kp[:, tbl].reshape(L, B, n_pg * page, KVH, hd)
    cv = vp[:, tbl].reshape(L, B, n_pg * page, KVH, hd)
    dcache = {"pos": torch.from_numpy(pos), "k": torch.from_numpy(ck),
              "v": torch.from_numpy(cv)}
    with torch.inference_mode():
        dl, _ = M.decode_step(pparams, torch.from_numpy(toks), dcache, pcfg,
                              lora, advance=torch.from_numpy(adv))
    np.testing.assert_allclose(pl.numpy(), dl.numpy(), rtol=1e-6, atol=1e-6)


# ===========================================================================
# (c) the host-side copies against the reference classes
# ===========================================================================

def _pool_step(pool, kind, arg):
    """One operation on a pool; returns what it observably did."""
    try:
        if kind == "alloc":
            out = pool.alloc(arg)
        elif kind == "retain":
            pool.retain(arg)
            out = None
        else:
            pool.release(arg)
            out = None
    except ValueError as e:
        return ("error", str(e))
    return (out, pool.free_pages, pool.used_pages, pool.peak_used,
            pool.shared_pages, [pool.refcount(p) for p in range(pool.n_pages)])


@requires_hypothesis
def test_page_pool_matches_reference_property():
    """``tests/test_paged_kv.py``'s allocator property replayed on both
    pools at once: every alloc/retain/release (double frees included) does
    the same thing to each, and the invariants hold after every op."""

    @given(ops_=st.lists(st.tuples(st.sampled_from(["alloc", "release",
                                                    "retain"]),
                                   st.integers(0, 5)),
                         min_size=1, max_size=60))
    @settings(max_examples=60, deadline=None)
    def check(ops_):
        jp, pp = jkv.PagePool(12, 8), pkv.PagePool(12, 8)
        owners = []
        for kind, n in ops_:
            if kind == "alloc":
                arg = n
            elif owners:
                arg = owners[n % len(owners)]
            else:
                continue
            a, b = _pool_step(jp, kind, arg), _pool_step(pp, kind, arg)
            assert a == b, (kind, arg, a, b)
            if kind == "alloc" and a[0]:
                owners.append(a[0])
            jp.check_invariants()
            pp.check_invariants()

    check()


def test_page_pool_basics():
    """``tests/test_paged_kv.py``'s basics on the port's pool."""
    pool = pkv.PagePool(n_pages=4, page_size=16)
    a = pool.alloc(3)
    assert len(a) == 3 and pool.free_pages == 1
    assert pool.alloc(2) is None            # all-or-nothing
    assert pool.free_pages == 1
    pool.retain(a)
    pool.release(a)
    assert pool.used_pages == 3             # still held by the retain
    pool.release(a)
    assert pool.used_pages == 0
    with pytest.raises(ValueError):
        pool.release([a[0]])                # double free
    for n in (0, 1, 16, 17):
        assert pkv.pages_for(n, 16) == jkv.pages_for(n, 16)


def test_snapshot_store_budget_and_nbytes():
    """The budget test of ``tests/test_paged_kv.py`` with torch tensors;
    a snapshot's byte count equals the JAX package's numpy arrays' of the
    same shape and dtype, bf16 included."""
    store = pkv.SnapshotStore(budget_bytes=100)
    small = pkv.KVSnapshot(pos=4, cur=1, ssm=torch.zeros(10))      # 40 B
    big = pkv.KVSnapshot(pos=4, cur=1, ssm=torch.zeros(32))        # 128 B
    assert store.try_add(small) and store.bytes_used == 40
    assert not store.try_add(big) and store.drops == 1
    store.remove(small)
    assert store.bytes_used == 0
    import ml_dtypes
    shape = (3, 2, 8, 2, 16)
    ours = pkv.KVSnapshot(pos=9, cur=1,
                          kpages=torch.zeros(shape, dtype=torch.bfloat16),
                          vpages=torch.zeros(shape, dtype=torch.bfloat16))
    theirs = jkv.KVSnapshot(pos=9, cur=1,
                            kpages=np.zeros(shape, ml_dtypes.bfloat16),
                            vpages=np.zeros(shape, ml_dtypes.bfloat16))
    assert ours.nbytes == theirs.nbytes == 2 * 2 * np.prod(shape)
    assert ours.n_pages == theirs.n_pages == 2


class _Req:
    def __init__(self, task_id, priority, max_new_tokens):
        self.task_id, self.priority = task_id, priority
        self.max_new_tokens = max_new_tokens


class _FakeRow:
    def __init__(self, i, rs):
        self.req = _Req(f"t{rs.randint(3)}", int(rs.randint(2)),
                        int(rs.randint(4, 40)))
        self.sampled = int(rs.randint(0, 5))
        self.submit_index = i
        self.forced_q = [1] if rs.rand() < 0.2 else []


@pytest.mark.parametrize("policy", ["srpt", "fifo"])
def test_slot_scheduler_pop_order_matches_reference(policy):
    """Random pushes, pops (with and without a filter), pop_if and predictor
    observations: both queues pop the same rows in the same order."""
    rs = np.random.RandomState(11)
    qs = [jsched.SlotScheduler(policy, jsched.LengthPredictor(0.3),
                               starvation_k=3),
          psched.SlotScheduler(policy, psched.LengthPredictor(0.3),
                               starvation_k=3)]
    popped = [[], []]
    refills = 0
    for i in range(300):
        op = rs.randint(5)
        if op <= 1:
            row = _FakeRow(i, rs)
            for q in qs:
                q.push(row, refills)
        elif op == 2:
            where = ((lambda r: r.submit_index % 3 != 0) if rs.rand() < 0.5
                     else None)
            for q, out in zip(qs, popped):
                r = q.pop(refills, where=where)
                out.append(None if r is None else r.submit_index)
            refills += 1
        elif op == 3:
            for q, out in zip(qs, popped):
                r = q.pop_if(refills, lambda r: r.req.priority == 0)
                out.append(None if r is None else r.submit_index)
        else:
            tenant, n = f"t{rs.randint(3)}", int(rs.randint(1, 30))
            for q in qs:
                q.predictor.observe(tenant, n)
        assert len(qs[0]) == len(qs[1])
        assert qs[0].tenants() == qs[1].tenants()
    assert popped[0] == popped[1]
    assert [r.submit_index for r in qs[0].pop_all()] == \
        [r.submit_index for r in qs[1].pop_all()]
    for t in ("t0", "t1", "t2"):
        assert qs[0].predictor.predict(t, 25) == qs[1].predictor.predict(t, 25)
    with pytest.raises(ValueError):
        psched.SlotScheduler("lifo")
