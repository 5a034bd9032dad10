"""The port's token_logprob (plain forward, plain backward, the autograd
node and the [B,S,d] wrapper) against the JAX package: repro.kernels.ref,
the Pallas kernel in interpret mode and jax.grad of the chunked plain path
of rl/grpo.py, on the same numpy inputs.

Tolerances: 1e-5 against the JAX plain versions — both sides compute the
same fp32 logits and reductions, in another summation order; 1e-4 against
the Pallas kernel, whose logits sum in 16-wide d-chunks and whose
statistics fold in 32-wide vocab tiles (the JAX package's own test uses
1e-4). Gradients at 1e-5 of their largest element."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.token_logprob import token_logprob_flat as pallas_flat
from repro.rl.grpo import token_logprobs_chunked as jax_chunked
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import token_logprob as ptl

TIGHT = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(16, 32, 64), (50, 48, 100), (8, 24, 52), (37, 40, 257)]  # ragged V


def _inputs(R, d, V, seed, layout):
    """h [R,d], w as [d,V] (numpy, the JAX side) and as the port sees it:
    'tied' is the transpose of a row-major [V,d] table (a strided view),
    'untied' a row-major [d,V] head."""
    rs = np.random.RandomState(seed)
    h = rs.randn(R, d).astype(np.float32)
    t = rs.randint(0, V, size=(R,)).astype(np.int32)
    if layout == "tied":
        table = (rs.randn(V, d) * 0.3).astype(np.float32)
        w_np = np.ascontiguousarray(table.T)
        w_pt = torch.from_numpy(table).T
    else:
        w_np = (rs.randn(d, V) * 0.3).astype(np.float32)
        w_pt = torch.from_numpy(w_np)
    return h, w_np, t, torch.from_numpy(h), w_pt, torch.from_numpy(t)


@pytest.mark.parametrize("layout", ["tied", "untied"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("R,d,V", SHAPES)
def test_plain_forward_matches_jax_ref_and_pallas(R, d, V, softcap, layout):
    h, w, t, ph, pw, pt = _inputs(R, d, V, R + V, layout)
    lp, ent = ptl.token_logprob_flat(ph, pw, pt, softcap)
    want_lp, want_ent = jref.token_logprob_ref(jnp.asarray(h), jnp.asarray(w),
                                               jnp.asarray(t), softcap)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), **TIGHT)
    np.testing.assert_allclose(ent.numpy(), np.asarray(want_ent), **TIGHT)
    k_lp, k_ent = pallas_flat(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                              bm=8, bv=32, bk=16, softcap=softcap)
    np.testing.assert_allclose(lp.numpy(), np.asarray(k_lp), **PALLAS)
    np.testing.assert_allclose(ent.numpy(), np.asarray(k_ent), **PALLAS)


def test_ops_wrapper_matches_jax_ops():
    rs = np.random.RandomState(0)
    B, S, d, V = 2, 8, 16, 40
    h = rs.randn(B, S, d).astype(np.float32)
    w = rs.randn(d, V).astype(np.float32)
    t = rs.randint(0, V, size=(B, S)).astype(np.int32)
    lp, ent = pops.token_logprob(torch.from_numpy(h), torch.from_numpy(w),
                                 torch.from_numpy(t))
    want_lp, want_ent = jops.token_logprob(jnp.asarray(h), jnp.asarray(w),
                                           jnp.asarray(t))
    assert lp.shape == (B, S) and ent.shape == (B, S)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), **PALLAS)
    np.testing.assert_allclose(ent.numpy(), np.asarray(want_ent), **PALLAS)


def _jax_grad_h(h, w, t, g_lp, g_ent, softcap):
    """jax.grad of sum(g_lp*lp + g_ent*ent) in h, through the chunked plain
    path the JAX trainer differentiates (token_logprobs_chunked)."""
    def f(hh):
        lp, ent = jax_chunked(hh[None], jnp.asarray(w), jnp.asarray(t)[None],
                              softcap, use_kernel=False)
        return jnp.sum(jnp.asarray(g_lp) * lp[0] + jnp.asarray(g_ent) * ent[0])
    return np.asarray(jax.grad(f)(jnp.asarray(h)))


def _close_to_scale(got, want, rel=1e-5):
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("layout", ["tied", "untied"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("R,d,V", SHAPES[1:3])
def test_plain_backward_matches_autograd_and_jax_grad(R, d, V, softcap, layout):
    h, w, t, ph, pw, pt = _inputs(R, d, V, 7 * R + V, layout)
    rs = np.random.RandomState(R)
    g_lp = rs.randn(R).astype(np.float32)
    g_ent = rs.randn(R).astype(np.float32)
    lp, ent, lse = pref.token_logprob_stats_ref(ph, pw, pt, softcap)
    dh = pref.token_logprob_bwd_ref(ph, pw, pt, lse, ent, torch.from_numpy(g_lp),
                                    torch.from_numpy(g_ent), softcap).numpy()
    hh = ph.clone().requires_grad_(True)
    a_lp, a_ent = pref.token_logprob_ref(hh, pw, pt, softcap)
    (a_lp @ torch.from_numpy(g_lp) + a_ent @ torch.from_numpy(g_ent)).backward()
    _close_to_scale(dh, hh.grad.numpy())
    _close_to_scale(dh, _jax_grad_h(h, w, t, g_lp, g_ent, softcap))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_autograd_node_wires_the_two_wrappers(softcap):
    """The card's autograd node (forward wrapper, backward wrapper; their
    plain versions on the CPU) gives the grads jax.grad gives, and no grad
    for w."""
    R, d, V = 24, 32, 97
    h, w, t, ph, pw, pt = _inputs(R, d, V, 3, "tied")
    rs = np.random.RandomState(4)
    g_lp = rs.randn(R).astype(np.float32)
    g_ent = rs.randn(R).astype(np.float32)
    hh = ph.clone().requires_grad_(True)
    lp, ent = ptl._TokenLogprob.apply(hh, pw, pt, softcap)
    want_lp, want_ent = jref.token_logprob_ref(jnp.asarray(h), jnp.asarray(w),
                                               jnp.asarray(t), softcap)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want_lp), **TIGHT)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(want_ent),
                               **TIGHT)
    (lp @ torch.from_numpy(g_lp) + ent @ torch.from_numpy(g_ent)).backward()
    _close_to_scale(hh.grad.numpy(), _jax_grad_h(h, w, t, g_lp, g_ent, softcap))
    assert ptl.FWD_LAUNCHES.n == 0 and ptl.BWD_LAUNCHES.n == 0   # no kernel ran


def test_reference_kernel_has_no_backward_the_port_has():
    """Recorded reference fault (ROADMAP §3): jax.grad through the Pallas
    token_logprob raises NotImplementedError, so the JAX trainer cannot run
    with use_logprob_kernel=True. The port's token_logprob differentiates
    (here its CPU path), in h and in w."""
    R, d, V = 8, 16, 40
    h, w, t, ph, pw, pt = _inputs(R, d, V, 11, "untied")

    def f(hh):
        lp, ent = jops.token_logprob(hh[None], jnp.asarray(w), jnp.asarray(t)[None])
        return jnp.sum(lp) + jnp.sum(ent)
    with pytest.raises(NotImplementedError):
        jax.grad(f)(jnp.asarray(h))

    hh = ph.clone().requires_grad_(True)
    ww = pw.clone().requires_grad_(True)
    lp, ent = pops.token_logprob(hh[None], ww, pt[None])
    (lp.sum() + ent.sum()).backward()
    want = _jax_grad_h(h, w, t, np.ones(R, np.float32), np.ones(R, np.float32),
                       0.0)
    _close_to_scale(hh.grad.numpy(), want)
    assert ww.grad is not None and bool(torch.isfinite(ww.grad).all())


def test_vocab_split_covers_the_vocabulary():
    """The card's split of the vocabulary into slices: every 64-column tile
    in exactly one slice, no empty slice, and enough blocks for the SMs."""
    for R, V in ((624, 151936), (4096, 151936), (5, 129), (37, 64), (1, 1)):
        for bm, target in ((64, 528), (32, 264)):
            n, per = ptl.vocab_split(R, V, bm, target)
            tiles = -(-V // 64)
            assert (n - 1) * per < tiles <= n * per
            assert n * -(-R // bm) >= min(target, tiles * -(-R // bm)) // 2


# The bf16 backward on the card: per vocab chunk, product 1 makes dz from the
# logits (rounded to bf16) and product 2 adds dz @ W^T into fp32 partials, one
# per K piece; a last pass sums the partials in order. Its tiling comes from
# backward_plan, which the card's wrapper allocates from.

@pytest.mark.parametrize("R,d,V", [(R, 1024, 151936) for R in (1, 624, 4096)]
                         + [(R, 2048, 49155) for R in (1, 624, 4096)]
                         + [(R, 1024, 129) for R in (1, 624, 4096)]
                         + [(624, 2048, 102400), (4096, 1024, 256206)])
def test_backward_plan_covers_the_work_once(R, d, V):
    """qwen3 (d=1024, V=151936), granite-3-2b (d=2048, V=49155), a tiny
    vocabulary, deepseek-moe's head (one chunk, one piece: the scratch
    nearest the limit) and seamless's: every vocab column in exactly one
    chunk, every K column of a chunk's padded width in exactly one piece,
    no more blocks than one wave of the card's slots (ptl._MM_SLOTS, one
    block an SM), and the scratch under the limit even as the CUDA caching
    allocator rounds each of its two buffers up to 2 MiB."""
    plan = ptl.backward_plan(R, d, V)
    assert plan.vc % ptl._TILE == 0 and plan.piece % ptl._TK == 0
    cover = np.zeros(V, np.int64)
    for v0 in range(0, V, plan.vc):
        cover[v0:v0 + plan.vc] += 1
        kpad = -(-min(plan.vc, V - v0) // 128) * 128
        k_cover = np.zeros(kpad, np.int64)
        for s in range(plan.splits):
            k_cover[s * plan.piece:(s + 1) * plan.piece] += 1
        assert (k_cover == 1).all()
    assert (cover == 1).all()
    tiles = -(-R // 128) * -(-d // 128)
    assert tiles * plan.splits <= max(ptl._MM_SLOTS, tiles)
    assert plan.scratch_bytes == R * plan.vc * 2 + plan.splits * R * d * 4
    blocks = [R * plan.vc * 2, plan.splits * R * d * 4]
    assert sum(-(-b // (2 << 20)) * (2 << 20) for b in blocks) \
        <= ptl.SCRATCH_LIMIT


def _two_product_dh(h, w, t, lse, ent, g_lp, g_ent, softcap, plan):
    """The card's bf16 backward in plain PyTorch: chunks of plan.vc vocab
    columns; dz in fp32 from the chunk's logits, rounded to h's dtype; fp32
    partials, one per K piece of the chunk's padded width, accumulated over
    the chunks in order and summed in order at the end."""
    R, d = h.shape
    V = w.shape[1]
    wf = w.float()
    part = torch.zeros(plan.splits, R, d)
    for v0 in range(0, V, plan.vc):
        kc = min(plan.vc, V - v0)
        kpad = -(-kc // 128) * 128
        z = h.float() @ wf[:, v0:v0 + kc]
        if softcap:
            z = torch.tanh(z / softcap) * softcap
        p = torch.exp(z - lse[:, None])
        hit = (torch.arange(v0, v0 + kc)[None, :] == t.long()[:, None]).float()
        dz = g_lp[:, None] * (hit - p) - g_ent[:, None] * p * (
            z - lse[:, None] + ent[:, None])
        if softcap:
            dz = dz * (1.0 - torch.square(z / softcap))
        dz = torch.nn.functional.pad(dz.to(h.dtype).float(), (0, kpad - kc))
        wt = torch.nn.functional.pad(wf[:, v0:v0 + kc], (0, kpad - kc)).T
        for s in range(plan.splits):
            k0, k1 = s * plan.piece, min(kpad, (s + 1) * plan.piece)
            if k0 < k1:
                part[s] += dz[:, k0:k1] @ wt[k0:k1]
    dh = part[0].clone()
    for s in range(1, plan.splits):
        dh += part[s]
    return dh.to(h.dtype)


@pytest.mark.parametrize("plan", ["auto", "chunked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_product_decomposition_matches_plain_backward(dtype, plan):
    """The decomposition (the algorithm; the kernel itself is held to the
    plain version by the card tests) equals token_logprob_bwd_ref, with and
    without a softcap: at 1e-5 of dh's largest element in fp32 (the sum
    order differs), at 1e-2 in bf16 (dz rounds to bf16 before dz @ W^T).
    'auto' is backward_plan's tiling (one chunk, many pieces, some of them
    empty); 'chunked' cuts V=300 into 128-column chunks, the last one
    ragged, each split in three pieces of 64 (the third empty)."""
    R, d, V = 37, 48, 300
    h, w, t, ph, pw, pt = _inputs(R, d, V, 5, "tied")
    ph, pw = ph.to(dtype), pw.to(dtype)
    rs = np.random.RandomState(6)
    g_lp = torch.from_numpy(rs.randn(R).astype(np.float32))
    g_ent = torch.from_numpy(rs.randn(R).astype(np.float32))
    cut = (ptl.backward_plan(R, d, V) if plan == "auto"
           else ptl.BackwardPlan(128, 3, 64, 0))
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    for softcap in (0.0, 30.0):
        _, ent, lse = pref.token_logprob_stats_ref(ph, pw, pt, softcap)
        got = _two_product_dh(ph, pw, pt, lse, ent, g_lp, g_ent, softcap, cut)
        want = pref.token_logprob_bwd_ref(ph, pw, pt, lse, ent, g_lp, g_ent,
                                          softcap)
        assert got.dtype == dtype
        scale = want.float().abs().max()
        assert (got.float() - want.float()).abs().max() <= rel * scale


# The bf16 forward on the card: grid (128-row tiles, vocab slices from
# forward_plan); a block walks its slice's 128-column tiles, folds each
# tile's per-row (m, l, s, target logit) into its running state and writes
# one partial per (slice, row); a merge launch combines the slices in order.

@pytest.mark.parametrize("R,d,V", [(R, 1024, 151936) for R in (1, 624, 4096)]
                         + [(R, 2048, 49155) for R in (1, 624, 4096)]
                         + [(R, 1024, 129) for R in (1, 624, 4096)])
def test_forward_plan_covers_the_vocabulary(R, d, V):
    """At the backward plan's shapes: every 128-column vocab tile in exactly
    one slice, no empty slice, at least a few tiles a slice where V has
    them, and the blocks (row tiles x slices) in whole waves of the card's
    block slots (ptl._MM_SLOTS) or fewer than one."""
    plan = ptl.forward_plan(R, V)
    n_tiles = -(-V // 128)
    cover = np.zeros(n_tiles, np.int64)
    for s in range(plan.vsplit):
        tiles = range(s * plan.slice_tiles,
                      min(n_tiles, (s + 1) * plan.slice_tiles))
        assert len(tiles) > 0
        cover[tiles.start:tiles.stop] += 1
    assert (cover == 1).all()
    assert plan.slice_tiles >= min(4, n_tiles)
    blocks = -(-R // 128) * plan.vsplit
    assert blocks <= ptl._MM_SLOTS or blocks % ptl._MM_SLOTS == 0, (blocks,
                                                                    plan)


_NEG = -1e30


def _merge_stats(a, b):
    """tlp_merge's fold of two (m, l, s, target logit) tuples of [R]."""
    m = torch.maximum(a[0], b[0])
    ea, eb = torch.exp(a[0] - m), torch.exp(b[0] - m)
    return (m, a[1] * ea + b[1] * eb, a[2] * ea + b[2] * eb,
            torch.maximum(a[3], b[3]))


def _tiled_forward(h, w, t, softcap, plan, mask=True):
    """The card's bf16 forward in plain PyTorch: W zero-filled to whole
    128-column tiles, as the kernel's loads fill it; per tile each row's
    (m, l, s, target logit) over the tile's columns, those past V left out
    (unless mask is False); folded over each slice's tiles in order, the
    slices merged in slice order. Returns (lp, ent, lse)."""
    R, V = h.shape[0], w.shape[1]
    n_tiles = -(-V // 128)
    wpad = torch.nn.functional.pad(w.float(), (0, n_tiles * 128 - V))
    empty = (torch.full((R,), _NEG), torch.zeros(R), torch.zeros(R),
             torch.full((R,), _NEG))
    parts = []
    for s in range(plan.vsplit):
        run = empty
        for tile in range(s * plan.slice_tiles,
                          min(n_tiles, (s + 1) * plan.slice_tiles)):
            cols = torch.arange(tile * 128, (tile + 1) * 128)
            z = h.float() @ wpad[:, cols]
            if softcap:
                z = torch.tanh(z / softcap) * softcap
            keep = cols < V if mask else torch.ones(128, dtype=torch.bool)
            zk = z[:, keep]
            m = zk.max(1).values
            p = torch.exp(zk - m[:, None])
            tv = torch.where(cols[None, :] == t.long()[:, None], z,
                             torch.tensor(_NEG)).max(1).values
            run = _merge_stats(run, (m, p.sum(1), (p * zk).sum(1), tv))
        parts.append(run)
    M = torch.stack([p[0] for p in parts]).max(0).values
    L, S, T = torch.zeros(R), torch.zeros(R), torch.full((R,), _NEG)
    for m, l, s, tv in parts:
        e = torch.exp(m - M)
        L, S, T = L + l * e, S + s * e, torch.maximum(T, tv)
    lse = M + torch.log(torch.clamp(L, min=1e-30))
    return T - lse, lse - S / torch.clamp(L, min=1e-30), lse


@pytest.mark.parametrize("plan", ["auto", "sliced"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_tiled_forward_matches_plain_and_pallas(softcap, plan):
    """The bf16 forward's algorithm (the kernel itself is held to the plain
    version by the card tests), in fp32, equals token_logprob_stats_ref and
    the JAX package's Pallas kernel in interpret mode at 1e-5. V = 300 ends
    in a ragged tile of 44 columns; 'auto' is forward_plan's one slice of 3
    tiles, 'sliced' two slices of 2 tiles, the second ragged."""
    R, d, V = 37, 48, 300
    h, w, t, ph, pw, pt = _inputs(R, d, V, 9, "tied")
    cut = (ptl.forward_plan(R, V) if plan == "auto"
           else ptl.ForwardPlan(2, 2))
    got = _tiled_forward(ph, pw, pt, softcap, cut)
    want = pref.token_logprob_stats_ref(ph, pw, pt, softcap)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TIGHT)
    k_lp, k_ent = pallas_flat(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                              bm=8, bv=100, softcap=softcap)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(k_lp), **TIGHT)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(k_ent), **TIGHT)


def test_unmasked_zero_fill_corrupts_the_lse():
    """The trap the kernel's epilogue masks: the zero-filled columns past V
    give logit 0, and counting them moves the lse and the entropy far past
    the forward's 1e-3 tolerance."""
    R, d, V = 37, 48, 300
    _, _, _, ph, pw, pt = _inputs(R, d, V, 9, "tied")
    plan = ptl.forward_plan(R, V)
    _, ent, lse = pref.token_logprob_stats_ref(ph, pw, pt)
    _, bad_ent, bad_lse = _tiled_forward(ph, pw, pt, 0.0, plan, mask=False)
    assert float((bad_lse - lse).abs().min()) > 1e-3
    assert float((bad_ent - ent).abs().max()) > 1e-3


# The bf16 kernels bring W's tiles to shared memory by TMA where its address
# and strides allow it, else by the kernels' own copies into the same
# swizzled layout; the wrapper picks the route (w_feed) from the pointer,
# shape and strides alone, and the C launchers refuse a TMA route they cannot
# take. torch.empty: the two 256206-wide heads are never touched.

def _head(kind):
    bf16 = torch.bfloat16
    if kind == "tied":               # the [V, d] embedding read as W = table.T
        return torch.empty(151936, 1024, dtype=bf16).T
    if kind == "padded":             # init_params' [:, :V] view of rows of 256208
        return torch.empty(1024, 256208, dtype=bf16)[:, :256206]
    if kind == "contiguous":         # the same head copied: rows of 512412 bytes
        return torch.empty(1024, 256206, dtype=bf16)
    if kind == "odd":                # an untied head at V = 5003: 2-byte rows
        return torch.empty(1024, 5003, dtype=bf16)
    if kind == "offset4":            # a view 4 bytes into 16-byte rows
        return torch.empty(1024, 5008, dtype=bf16)[:, 2:5005]
    if kind == "view_k":             # strided views of larger tables, as in the
        return torch.empty(3 * 5003, 2 * 1024, dtype=bf16)[::3, ::2].T  # card
    if kind == "view_v":             # tests: neither stride is 1
        return torch.empty(2 * 1024, 3 * 5003, dtype=bf16)[::2, ::3]
    if kind == "overlap":            # 16-byte rows that overlap the next one
        return torch.empty(1023 * 8 + 5003, dtype=bf16).as_strided(
            (1024, 5003), (8, 1))
    raise ValueError(kind)


@pytest.mark.parametrize("kind,want", [
    ("tied", ("tma", 16, "k")), ("padded", ("tma", 16, "v")),
    ("contiguous", ("cp.async", 4, "v")), ("odd", ("loads", 2, "v")),
    ("offset4", ("cp.async", 4, "v")), ("view_k", ("loads", 2, "k")),
    ("view_v", ("loads", 2, "v")), ("overlap", ("cp.async", 16, "v"))])
def test_w_feed_routes_w_by_address_and_strides(kind, want):
    """TMA for the tied transpose and the row-padded untied head (16-byte
    aligned rows no shorter than the contiguous extent); the kernel's
    cp.async copies, 4 bytes wide, for the contiguous head at V = 256206
    (rows 4 bytes aligned) and a view whose base is 4 bytes into an aligned
    row, 16 bytes wide for aligned rows that overlap the next one (no
    tensor TMA can describe); 2-byte loads for an odd row stride and for
    views with no unit stride. The route follows the pointer too: the same
    strides from an aligned base take TMA."""
    w = _head(kind)
    assert w.data_ptr() % 16 == (4 if kind == "offset4" else 0)
    feed = ptl.w_feed(w.data_ptr(), tuple(w.shape), w.stride())
    assert tuple(feed) == want
    if kind == "offset4":
        assert ptl.w_feed(w.data_ptr() - 4, tuple(w.shape), w.stride()).route \
            == "tma"

