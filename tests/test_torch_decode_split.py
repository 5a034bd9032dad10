"""The decode kernels' split over keys, on the CPU.

``gqa_decode`` and ``paged_gqa_decode`` on the card cut each row's keys
into chunks (``decode_plan``); each live chunk's block forms an fp32
partial softmax (running max m, sum l, accumulator acc, scores in log2
units) and the partials merge in split order. Here:
(a) ``decode_plan`` covers every key of the capacity exactly once, with
    pool chunks a whole number of pages, from static shapes only;
(b) a plain-PyTorch emulation of those partials and their in-order merge at
    the plan's chunk equals the port's plain versions and the JAX package's
    Pallas kernels (interpret mode, as its own tests run them) on the same
    numpy inputs, fp32 within 1e-5, with empty chunks, windows and softcap;
(c) merging an all-masked partial with m = -inf gives NaN, which is why the
    kernels start m at -1e30.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 3)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax.numpy as jnp

from repro.kernels.gqa_decode import gqa_decode as jax_gqa_decode
from repro.kernels.paged_decode import paged_gqa_decode as jax_paged
from repro_torch.kernels import gqa_decode as gqa_mod
from repro_torch.kernels.gqa_decode import decode_plan
from repro_torch.kernels.ref import gqa_decode_ref, paged_gqa_decode_ref

LOG2E = 1.4426950408889634
NEG = -1e30            # decode_common.cuh's kNegInf
TOL = 1e-5


# ===========================================================================
# (a) the plan
# ===========================================================================

@pytest.mark.parametrize("page", [1, 8, 16, 64])
def test_decode_plan_covers_every_key_once(page):
    for B in (1, 3, 16, 64, 300):
        for KVH in (1, 2, 8):
            for capacity in (1, 8, 56, 256, 512, 1000, 4096, 65536):
                if capacity % page:
                    continue
                plan = decode_plan(B, KVH, capacity, page, H=2 * KVH, hd=128)
                c, n = plan.chunk, plan.splits
                assert c % page == 0 and c // page <= gqa_mod._MAX_CHUNK_PAGES
                assert plan.grid == (n, KVH, B)
                # the splits' ranges [s*c, (s+1)*c) cover [0, capacity) once
                assert (n - 1) * c < capacity <= n * c
                seen = np.zeros(capacity, np.int64)
                for s in range(n):
                    seen[s * c:min((s + 1) * c, capacity)] += 1
                assert (seen == 1).all()
                want = B * 2 * KVH * n * (128 + 2) * 4 if n > 1 else 0
                assert plan.scratch_bytes == want
                # 8 warps a block only for few blocks
                few = B * KVH * n <= gqa_mod._FEW_BLOCKS
                assert plan.warps == (8 if few else 4)


@pytest.mark.parametrize("page", [1, 16])
def test_windowed_plan_reaches_every_live_key(page):
    """With a window the grid holds cdiv(window + page - 1, chunk) splits a
    row (fewer than the capacity's chunks): for every pos and window the
    row's live chunks, counted from its first live page, fit in them and
    cover its live keys [max(0, pos - window), min(pos, capacity)) exactly
    once; a window no longer than a chunk less a page takes one."""
    for capacity in (256, 1000 // page * page, 4096):
        for window in (1, 5, 24, 127, 128, 129, 300, 5000):
            plan = decode_plan(4, 8, capacity, page, H=16, hd=64,
                               window=window)
            assert plan.splits <= -(-capacity // plan.chunk)
            if window <= plan.chunk - page + 1:
                assert plan.splits == 1
            for p in range(1, capacity + 40, 7):
                lo, hi, chunks = _span(p, capacity, window, plan.chunk, page)
                assert len(chunks) <= plan.splits
                seen = np.zeros(capacity, np.int64)
                for k0, k1 in chunks:
                    seen[k0:max(k0, k1)] += 1
                assert (seen[lo:hi] == 1).all()
                assert seen.sum() == max(0, hi - lo)


def test_decode_plan_fills_the_card_at_long_caches():
    """B x KVH x splits comes to several blocks for each of an H100's 132
    SMs at long caches (the target, less the chunk's rounding to whole
    units); the chunk never drops under its minimum (short rows stay in one
    block)."""
    for capacity, page in ((1000, 1), (4096, 1), (4096, 16), (512, 16)):
        plan = decode_plan(16, 8, capacity, page, H=16, hd=128)
        assert plan.chunk >= gqa_mod._MIN_CHUNK
        blocks = 16 * 8 * plan.splits
        if capacity >= 1000:
            assert blocks >= 4 * 132
    # the serving shape: pos <= 40 lies in one chunk, so one block of each
    # (row, kv head) writes the output directly, with 8 warps
    serve = decode_plan(16, 8, 256, 1, H=16, hd=128)
    assert serve.chunk >= 40 and serve.warps == 8
    # 8 warps' fold must fit: never where rep * hd > 1024
    assert decode_plan(1, 1, 4096, 1, H=8, hd=256).warps == 4
    assert decode_plan(1, 1, 4096, 1, H=4, hd=256).warps == 8


# ===========================================================================
# (b) the partials and their in-order merge
# ===========================================================================

def _span(p, capacity, window, chunk, align=1):
    """decode_common.cuh's span: the row's live keys [lo, hi), and the keys
    [k0, k1) of each of its n_live chunks, counted from lo rounded down to a
    multiple of `align` (the page)."""
    hi = min(p, capacity)
    lo = max(0, p - window) if window > 0 else 0
    base = lo // align * align
    n_live = -(-(hi - base) // chunk) if hi > lo else 1
    return lo, hi, [(max(lo, base + s * chunk), min(hi, base + (s + 1) * chunk))
                    for s in range(n_live)]


def _merge(parts, neg=NEG):
    """Fold (m, l, acc) partials in list order, as the last block does, the
    running max starting at `neg`."""
    M = torch.full_like(parts[0][0], neg)
    for m, _, _ in parts:
        M = torch.maximum(M, m)
    L = torch.zeros_like(parts[0][1])
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp2(m - M)
        L = L + l * f
        A = A + acc * f[..., None]
    return A / torch.clamp(L, min=1e-30)[..., None]


def _split_decode(q, ck, cv, pos, plan, softcap=0.0, window=0, page=1):
    """The kernels' arithmetic at the plan's chunk, in plain PyTorch (fp32):
    per live chunk of each row a partial (m, l, acc) over its keys, then
    the partials merged in split order. ck/cv: [B, capacity, KVH, hd]."""
    B, H, hd = q.shape
    capacity, KVH = ck.shape[1], ck.shape[2]
    rep = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qs = q.float() * (scale / softcap if softcap else scale * LOG2E)
    out = torch.empty(B, H, hd)
    covered = 0
    for b in range(B):
        lo, hi, chunks = _span(int(pos[b]), capacity, window, plan.chunk,
                               page)
        qg = qs[b].reshape(KVH, rep, hd)
        parts = []
        assert len(chunks) <= plan.splits           # the grid reaches them
        for k0, k1 in chunks:
            covered += max(0, k1 - k0)
            k, v = ck[b, k0:k1].float(), cv[b, k0:k1].float()
            sc = torch.einsum("grd,ngd->grn", qg, k)
            if softcap:
                sc = torch.tanh(sc) * (softcap * LOG2E)
            if k1 > k0:
                m = sc.max(-1).values
            else:
                m = torch.full((KVH, rep), NEG)
            w = torch.exp2(sc - m[..., None])
            parts.append((m, w.sum(-1), torch.einsum("grn,ngd->grd", w, v)))
        out[b] = _merge(parts).reshape(H, hd)
    want = sum(max(0, min(int(p), capacity) - (max(0, int(p) - window)
                                               if window else 0))
               for p in pos)
    assert covered == want          # every live key in exactly one chunk
    return out


def _live_splits(pos, capacity, window, chunk, align=1):
    return [len(_span(int(p), capacity, window, chunk, align)[2]) for p in pos]


@pytest.mark.parametrize("B,H,KVH,hd,S", [
    (5, 4, 2, 16, 256), (3, 8, 2, 32, 192), (1, 16, 8, 64, 256),
])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 24),
                                            (0.0, 200)])
def test_split_decode_matches_plain_and_jax(B, H, KVH, hd, S, softcap, window):
    rs = np.random.RandomState(B * S + H + window)
    q = rs.randn(B, H, hd).astype(np.float32)
    ck = rs.randn(B, S, KVH, hd).astype(np.float32)
    cv = rs.randn(B, S, KVH, hd).astype(np.float32)
    plan = decode_plan(B, KVH, S, 1, H=H, hd=hd, window=window)
    assert plan.splits > 1 or 0 < window <= plan.chunk    # window 24: one
    # rows at a chunk's edges and at the end; the first row's later chunks
    # are all empty
    c = plan.chunk
    pos = np.array([1, c - 1, c, c + 1][:B - 1] + [S], np.int32)
    got = _split_decode(*(torch.from_numpy(v) for v in (q, ck, cv, pos)),
                        plan, softcap, window)
    plain = gqa_decode_ref(*(torch.from_numpy(v) for v in (q, ck, cv, pos)),
                           softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    jin = [jnp.asarray(v) for v in (q, ck, cv, pos)]
    want = jax_gqa_decode(*jin, bs=32, softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("B,H,KVH,hd,n_pg,page", [
    (2, 4, 2, 16, 16, 16), (3, 8, 2, 32, 40, 8),
])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 5),
                                            (0.0, 150)])
def test_split_paged_decode_matches_plain_and_jax(B, H, KVH, hd, n_pg, page,
                                                  softcap, window):
    """The pool's chunks are whole pages; a window smaller than a page (one
    chunk) and one that straddles a chunk edge."""
    rs = np.random.RandomState(B * n_pg * page + H + window)
    cap = n_pg * page
    plan = decode_plan(B, KVH, cap, page, H=H, hd=hd, window=window)
    assert plan.chunk % page == 0
    assert plan.splits > 1 or 0 < window <= plan.chunk - page + 1
    q = rs.randn(B, H, hd).astype(np.float32)
    P = B * n_pg + 2
    kp = rs.randn(P + 1, page, KVH, hd).astype(np.float32)
    vp = rs.randn(P + 1, page, KVH, hd).astype(np.float32)
    tbl = rs.permutation(P)[:B * n_pg].reshape(B, n_pg).astype(np.int32)
    pos = np.array([plan.chunk, plan.chunk + 3, cap][:B], np.int32)
    live = -(-pos // page)
    tbl[np.arange(n_pg)[None, :] >= live[:, None]] = P       # sentinel
    t = [torch.from_numpy(v) for v in (q, kp, vp, tbl, pos)]
    gathered = [t[i][t[3].long()].reshape(B, cap, KVH, hd) for i in (1, 2)]
    got = _split_decode(t[0], *gathered, t[4], plan, softcap, window, page)
    plain = paged_gqa_decode_ref(*t, softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    want = jax_paged(*(jnp.asarray(v) for v in (q, kp, vp, tbl, pos)),
                     softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_live_splits_follow_pos_and_window():
    """Which blocks work: with chunk 128 of 512 keys, a row at pos 1 has one
    live split, pos 129 two, pos 512 four. With a window the chunks count
    from the window's first key (contiguous) or its page (pool, page 16): a
    window of 24 at pos 140 (keys 116..139) is one chunk, and so is a window
    of 100 or 120 in the pool (keys 40..139 from key 32, 20..139 from key
    16); a window of 125 there (keys 15..139, from key 0) takes two."""
    assert _live_splits([1, 128, 129, 512], 512, 0, 128) == [1, 1, 2, 4]
    assert _span(140, 512, 24, 128) == (116, 140, [(116, 140)])
    assert _live_splits([140], 512, 100, 128, 16) == [1]
    assert _live_splits([140], 512, 120, 128, 16) == [1]
    assert _span(140, 512, 125, 128, 16) == (15, 140, [(15, 128), (128, 140)])
    # pos past the capacity attends to the whole cache
    assert _span(600, 512, 0, 128)[:2] == (0, 512)
    assert _live_splits([600], 512, 0, 128) == [4]


# ===========================================================================
# (c) why m starts at -1e30
# ===========================================================================

def test_all_masked_partial_merges_as_zero_not_nan():
    """A split (or a virtual warp) that saw no key keeps l = 0, acc = 0 and
    its initial m. With m = -inf, merging partials that are all empty (a
    row, or a warp, with no key) takes exp2(-inf - -inf) = NaN and the NaN
    spreads; with m = -1e30 the same merge gives 0. Beside a live partial
    both weigh the empty one exp2(m - M) = 0."""
    rs = np.random.RandomState(0)
    live = (torch.tensor([[0.7]]), torch.tensor([[2.5]]),
            torch.from_numpy(rs.randn(1, 1, 8).astype(np.float32)))
    for neg in (float("-inf"), NEG):
        empty = (torch.tensor([[neg]]), torch.zeros(1, 1),
                 torch.zeros(1, 1, 8))
        torch.testing.assert_close(_merge([empty, live], neg),
                                   live[2] / live[1][..., None],
                                   rtol=0, atol=0)
        alone = _merge([empty, empty], neg)
        if neg == NEG:
            assert torch.equal(alone, torch.zeros(1, 1, 8))
        else:
            assert torch.isnan(alone).all()
