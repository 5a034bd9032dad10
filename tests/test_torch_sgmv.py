"""The port's SGMV design on the CPU: the segment table and the plan the
card's kernel (src/repro_torch/kernels/csrc/sgmv.cu) launches with, a
plain-PyTorch emulation of that kernel (split-d partials summed in cluster
rank order, the column tiles, both epilogues) against the JAX package's
Pallas kernel in interpret mode and the plain versions, the in-place
epilogue's rounding, and the batched projection seam against JAX's `proj`.

Tolerances: fp32 rtol 1e-5 and atol 1e-4 against the JAX kernel and the
plain versions — the emulation sums d in C slices and the JAX kernel in
512-wide blocks, each in another order than a dense matmul (the JAX
package's own sgmv tests use 1e-5 / 1e-4). The epilogue and the table are
checked exactly. The seam at 1e-5, as tests/test_torch_model.py."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.sgmv import sgmv as jax_sgmv
from repro.lora.adapters import batched_ctx as jax_batched_ctx
from repro.models import common as jcommon
from repro_torch.kernels import ref as pref
from repro_torch.kernels import sgmv as ps
from repro_torch.lora.adapters import batched_ctx, target_dims
from repro_torch.models import common as pcommon
from test_torch_model import CONFIGS, _adapters, _configs

FP32 = dict(rtol=1e-5, atol=1e-4)
ACT = dict(rtol=1e-5, atol=1e-5)


def _ids(rs, R, T, kind):
    """Row slots of one kind: uniform, all rows on one slot, or half the
    slots left empty."""
    if kind == "one":
        return np.full(R, rs.randint(T), np.int32)
    if kind == "holes":
        live = rs.choice(T, size=max(1, T // 2), replace=False)
        return rs.choice(live, size=R).astype(np.int32)
    return rs.randint(0, T, size=R).astype(np.int32)


def _segments(table):
    """Each slot's first position in `order` and its first row tile."""
    counts = np.bincount(table.ids.numpy(), minlength=table.slots)
    return (np.concatenate([[0], np.cumsum(counts)]),
            np.concatenate([[0], np.cumsum(-(-counts // table.bm))]))


def _tile_rows(table, plan):
    """The rows each row tile of the grid takes, as the kernel reads them
    (csrc/sgmv.cu: row y of `tmap` is the slot, the live rows, the rows),
    after checking `tmap` against the segments: tile y of slot u takes
    `order[seg[u] + (y - tiles[u]) * bm:]`, at most bm rows."""
    T = table.slots
    seg, tiles = (v.tolist() for v in _segments(table))
    order = table.order.tolist()
    tmap = table.tmap.tolist()
    assert table.tmap.shape == (plan.row_tiles, plan.bm + 2)
    out = []
    for tile in range(plan.row_tiles):
        hit = [u for u in range(T) if tiles[u] <= tile < tiles[u + 1]]
        assert len(hit) <= 1
        if not hit:
            assert tmap[tile] == [-1] * (plan.bm + 2)
            out.append(None)
            continue
        u = hit[0]
        first = seg[u] + (tile - tiles[u]) * plan.bm
        live = min(plan.bm, seg[u + 1] - first)
        assert 0 < live <= plan.bm
        assert tmap[tile] == [u, live] + order[first:first + live] \
            + [-1] * (plan.bm - live)
        out.append((u, order[first:first + live]))
    return out


# --------------------------------------------------------------------------
# the segment table and the plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "one", "holes"])
@pytest.mark.parametrize("S", [1, 3])
def test_segment_table_covers_every_row_once(kind, S):
    """Over random (R, T): `order` lists every row once, in stable order of
    slot; `tmap` gives each of the grid's row tiles its slot's next rows,
    so the tiles take every row exactly once, each from its own slot, live
    tiles first; with S > 1 row b * S + s belongs to sequence b."""
    rs = np.random.RandomState(7 * S + len(kind))
    for _ in range(40):
        T = rs.randint(1, 17)
        B = max(1, rs.randint(1, 301) // S)
        ids = _ids(rs, B, T, kind)
        table = ps.sgmv_table(torch.from_numpy(ids), T, S)
        rows = np.repeat(ids, S)
        R = rows.shape[0]
        assert table.ids.tolist() == rows.tolist() and table.slots == T
        order = table.order.numpy()
        assert table.order.dtype == torch.int32 and table.tmap.dtype == torch.int32
        np.testing.assert_array_equal(order, np.argsort(rows, kind="stable"))
        tiles = _segments(table)[1]
        plan = ps.sgmv_plan(R, T, 64, 48, r=16)
        assert plan.bm == table.bm and tiles[-1] <= plan.row_tiles
        seen = []
        for tile, got in enumerate(_tile_rows(table, plan)):
            if got is None:
                assert tile >= tiles[-1]
                continue
            u, rws = got
            assert all(rows[i] == u for i in rws) and rws == sorted(rws)
            seen += rws
        assert sorted(seen) == list(range(R))


def test_static_grid_bound_covers_the_worst_case():
    """R // bm + min(T, R) row tiles hold every way of spreading R rows over
    T slots: the most tiles any spread needs (exact, by dynamic
    programming) never exceeds it."""
    for bm in (16, 32, 64):
        for T in range(1, 7):
            # most[n]: the most tiles n rows can need over the slots so far
            most = [0] + [-1] * 200
            for _ in range(T):
                most = [max(most[n - c] + -(-c // bm) for c in range(n + 1)
                            if most[n - c] >= 0) for n in range(201)]
            for R in range(201):
                assert most[R] <= ps.row_tiles(R, T, bm), (bm, T, R)
    # and the plan's bound is the one the kernel's grid gets
    for R, T in itertools.product((1, 16, 17, 128, 300, 2048), (1, 4, 16)):
        plan = ps.sgmv_plan(R, T, 1024, 6144)
        assert plan.row_tiles == ps.row_tiles(R, T, plan.bm) == plan.grid[1]


@pytest.mark.parametrize("r", ps.RANKS)
@pytest.mark.parametrize("x_bytes", [2, 4])
def test_plan_shapes(r, x_bytes):
    """Every plan: a row tile of 16, 32 or 64; a power-of-two column tile of
    64-1024 whose B tile fits 64 KB; clusters of 2-8 covering dout; two
    blocks' shared memory on a SM, but for the narrowest ring stage; each rank's d slice the least multiple
    of 8 that lets the C slices cover d (the last ones may be empty)."""
    for R, T, d, dout in itertools.product((1, 16, 128, 300, 2048), (1, 4, 16),
                                           (64, 72, 1024, 3072),
                                           (4, 100, 1024, 6144)):
        p = ps.sgmv_plan(R, T, d, dout, r=r, x_bytes=x_bytes)
        assert p.bm in (16, 32, 64) and p.bm >= min(64, -(-R // T))
        assert p.bn in (64, 128, 256, 512, 1024) and r * p.bn * 4 <= 64 * 1024
        assert 2 <= p.cluster <= 8 and p.grid == (p.col_groups * p.cluster,
                                                  p.row_tiles)
        assert p.grid[0] * p.bn >= dout > (p.col_groups - 1) * p.cluster * p.bn
        dc = ps.slice_of(d, p.cluster)
        assert p.smem_bytes == ps.smem_bytes(p.bm, p.bn, p.kc,
                                             ps.ring_stages(dc, p.kc), r,
                                             x_bytes, p.cluster)
        assert p.kc % 16 == 0 and p.kc >= 16 and (p.kc <= 128 or p.kc >= dc)
        assert p.smem_bytes <= 113 * 1024 or p.kc == 16 and p.smem_bytes <= 200 * 1024
        dc = ps.slice_of(d, p.cluster)
        assert dc % 8 == 0 and dc * p.cluster >= d and dc - 8 < -(-d // p.cluster)


def test_plan_fills_the_card_in_decode():
    """At the serving path's decode shapes (R=16 rows of 4 adapters, rank
    16) the plan gives one row tile an adapter, at least 16 blocks a row
    tile, no more than two blocks a SM over the 4 live tiles, clusters of
    8, and a d slice a block loads in one chunk, one load round trip; with
    16 adapters (one row each) it widens the column tile to stay within
    two blocks a SM."""
    for d, dout in ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 6144),
                    (3072, 1024)):
        p = ps.sgmv_plan(16, 4, d, dout)
        assert p.bm == 16 and p.row_tiles == 5 and p.cluster == 8
        assert 16 <= p.grid[0] and 4 * p.grid[0] <= 2 * 132
        assert -(-ps.slice_of(d, p.cluster) // p.kc) == 1
    p = ps.sgmv_plan(16, 16, 1024, 6144)
    assert p.bn > ps.sgmv_plan(16, 4, 1024, 6144).bn and 16 * p.grid[0] <= 2 * 132


# --------------------------------------------------------------------------
# the kernel, emulated
# --------------------------------------------------------------------------

def emulate(rows, a, b, table, plan, *, y=None, scaling=1.0):
    """csrc/sgmv.cu's arithmetic in plain PyTorch: per live row tile, each
    cluster rank's partial h over its d slice, the partials summed in rank
    order, then each block's column tile of h @ B. Without `y` it returns
    the fp32 product (epilogue a; NaN where no block wrote); with `y` it
    returns y + (scaling * product).to(rows.dtype), rounded to y's dtype
    (epilogue b)."""
    R, d = rows.shape
    r, dout = a.shape[2], b.shape[2]
    C, bn = plan.cluster, plan.bn
    dc = ps.slice_of(d, C)
    out = torch.full((R, dout), float("nan")) if y is None else y.clone()
    written = torch.zeros((R, dout), dtype=torch.int32)
    for got in _tile_rows(table, plan):
        if got is None:
            continue
        u, idx = got
        xs = rows[idx].float()
        h = None
        for c in range(C):
            k0, k1 = c * dc, min(d, (c + 1) * dc)
            part = xs[:, k0:k1] @ a[u, k0:k1] if k1 > k0 \
                else torch.zeros(len(idx), r)
            h = part if h is None else h + part
        for ct in range(plan.grid[0]):
            n0 = ct * bn
            if n0 >= dout:
                continue
            cols = slice(n0, min(dout, n0 + bn))
            acc = h @ b[u][:, cols]
            if y is None:
                out[idx, cols] = acc
            else:
                delta = (acc * scaling).to(rows.dtype)
                out[idx, cols] = (out[idx, cols].float() + delta.float()).to(y.dtype)
            written[idx, cols] += 1
    assert bool((written == 1).all()), "an output written more or less than once"
    return out


def _case(R, d, r, dout, T, kind, seed, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    x = rs.randn(R, d).astype(np.float32)
    a = (rs.randn(T, d, r) / np.sqrt(d)).astype(np.float32)
    b = (rs.randn(T, r, dout) * 0.1).astype(np.float32)
    ids = _ids(rs, R, T, kind)
    tx = torch.from_numpy(x).to(dtype)
    return x, a, b, ids, tx, torch.from_numpy(a), torch.from_numpy(b)


EMU_CASES = [  # R, d, r, dout, T, kind
    (16, 64, 16, 256, 4, "uniform"),       # decode at the reduced widths
    (16, 128, 16, 96, 16, "uniform"),      # about one row an adapter
    (48, 72, 4, 100, 5, "holes"),          # ragged d slices and dout, empty slots
    (130, 64, 8, 40, 3, "one"),            # every row on one adapter, 3 tiles
    (300, 96, 32, 1100, 16, "uniform"),    # several tiles an adapter, 32 ranks
]


@pytest.mark.parametrize("R,d,r,dout,T,kind", EMU_CASES)
def test_emulated_kernel_matches_jax_and_plain(R, d, r, dout, T, kind):
    x, a, b, ids, tx, ta, tb = _case(R, d, r, dout, T, kind, R + d)
    table = ps.sgmv_table(torch.from_numpy(ids), T)
    plan = ps.sgmv_plan(R, T, d, dout, r=r, x_bytes=4)
    got = emulate(tx, ta, tb, table, plan)
    want_j = jax_sgmv(*(jnp.asarray(v) for v in (x, a, b, ids)))
    want_r = jref.sgmv_ref(*(jnp.asarray(v) for v in (x, a, b, ids)))
    for want in (want_j, want_r, pref.sgmv_ref(tx, ta, tb, torch.from_numpy(ids))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    # the wrapper's CPU path, with ids and with the table
    for out in (ps.sgmv(tx, ta, tb, torch.from_numpy(ids)),
                ps.sgmv(tx, ta, tb, None, table=table)):
        np.testing.assert_allclose(out.numpy(), got.numpy(), **FP32)


@pytest.mark.parametrize("R,d,r,dout,T,kind", EMU_CASES[:3])
def test_emulated_add_epilogue_matches_plain(R, d, r, dout, T, kind):
    """Epilogue b, fp32 rows: the emulation, sgmv_add_ on the CPU and the
    plain version against y + s * (the JAX kernel's product)."""
    x, a, b, ids, tx, ta, tb = _case(R, d, r, dout, T, kind, 3 * R + d)
    y0 = torch.from_numpy(np.random.RandomState(1).randn(R, dout)
                          .astype(np.float32))
    s = 0.37
    table = ps.sgmv_table(torch.from_numpy(ids), T)
    plan = ps.sgmv_plan(R, T, d, dout, r=r, x_bytes=4)
    want = y0.numpy() + s * np.asarray(jax_sgmv(*(jnp.asarray(v)
                                                  for v in (x, a, b, ids))))
    got = emulate(tx, ta, tb, table, plan, y=y0, scaling=s)
    for out in (got, ps.sgmv_add_(y0.clone(), tx, ta, tb, table, s),
                pref.sgmv_add_ref(y0.clone(), tx, ta, tb, table.ids, s)):
        np.testing.assert_allclose(out.numpy(), want, **FP32)


@pytest.mark.parametrize("S", [1, 4])
def test_emulated_kernel_over_sequences(S):
    """Prefill's rows: B sequences of S rows, the table from per-sequence
    ids (the repeat the JAX wrapper does per call, done once here)."""
    rs = np.random.RandomState(S)
    B, d, r, dout, T = 9, 64, 4, 128, 3
    x = rs.randn(B * S, d).astype(np.float32)
    a = (rs.randn(T, d, r) / 8).astype(np.float32)
    b = (rs.randn(T, r, dout) * 0.1).astype(np.float32)
    seq_ids = rs.randint(0, T, size=B).astype(np.int32)
    table = ps.sgmv_table(torch.from_numpy(seq_ids), T, S)
    plan = ps.sgmv_plan(B * S, T, d, dout, r=r, x_bytes=4)
    got = emulate(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
                  table, plan)
    want = jax_sgmv(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                    jnp.repeat(jnp.asarray(seq_ids), S))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def _bf16_rne(f32):
    """fp32 -> bf16 bits, round to nearest even, as __float2bfloat16_rn
    (finite inputs)."""
    u = f32.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return (u << 16).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_add_epilogue_is_bit_equal_to_the_torch_composition(dtype):
    """csrc/sgmv.cu's in-place epilogue, y = round_y(y + round_x(s * acc))
    with fp32 __fmul_rn and __fadd_rn and no FMA, written out in numpy,
    gives the bits of `y + (acc * s).to(x.dtype)` in torch and of
    sgmv_add_ref's `y.add_(...)`, for the same fp32 product acc."""
    rs = np.random.RandomState(5)
    n = 20000
    acc = (rs.randn(n) * np.exp(rs.uniform(-12, 6, n))).astype(np.float32)
    acc[:200] = np.ldexp(rs.randint(-256, 256, 200), -12).astype(np.float32)  # ties
    y32 = (rs.randn(n) * np.exp(rs.uniform(-6, 6, n))).astype(np.float32)
    tdt = getattr(torch, dtype)
    rnd = _bf16_rne if dtype == "bfloat16" else (lambda v: v)
    y = rnd(y32)
    for s in (0.37, 2.0, 1.0 / 3.0):
        prod = np.float32(acc) * np.float32(s)              # __fmul_rn
        want = rnd(np.float32(y + rnd(prod)))                # __fadd_rn, round_y
        ty = torch.from_numpy(y).to(tdt)
        delta = torch.from_numpy(acc) * s
        comp = (ty + delta.to(tdt)).float().numpy()
        inplace = ty.clone().add_(delta.to(tdt)).float().numpy()
        np.testing.assert_array_equal(comp.view(np.uint32), want.view(np.uint32))
        np.testing.assert_array_equal(inplace.view(np.uint32), want.view(np.uint32))


def test_reference_sgmv_has_no_backward_the_port_has():
    """Recorded divergence (ROADMAP §3): jax.grad through the Pallas sgmv
    raises (the pallas_call has no VJP). The port's CPU path (the plain
    version) differentiates, matching jax.grad of the JAX plain version;
    on the card the wrapper raises instead (tests/test_torch_cuda.py)."""
    x, a, b, ids, tx, ta, tb = _case(12, 32, 4, 24, 3, "uniform", 2)

    def f(xx):
        return jnp.sum(jax_sgmv(xx, jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(ids)) ** 2)
    with pytest.raises(NotImplementedError):
        jax.grad(f)(jnp.asarray(x))

    want = jax.grad(lambda xx: jnp.sum(jref.sgmv_ref(
        xx, jnp.asarray(a), jnp.asarray(b), jnp.asarray(ids)) ** 2))(jnp.asarray(x))
    xx = tx.clone().requires_grad_(True)
    (ps.sgmv(xx, ta, tb, torch.from_numpy(ids)) ** 2).sum().backward()
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(want), **FP32)


# --------------------------------------------------------------------------
# the seam
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_batched_proj_matches_jax(name):
    """proj with a batched ctx on the CPU (y + multi_lora_delta_ref) equals
    JAX's proj on every adapted projection of layer 0, for decode rows
    [B, d] and prefill rows [B, S, d], with and without a bias."""
    from repro.lora.adapters import stack_adapters as jax_stack
    from repro_torch import bridge
    from repro_torch.lora.adapters import stack_adapters

    jcfg, pcfg = _configs(name)
    trees = _adapters(jcfg, 3, seed=4)
    jstack = jax_stack([jax.tree.map(jnp.asarray, t) for t in trees])
    pstack = stack_adapters([bridge.lora_from_jax(t, "cpu") for t in trees])
    ids = np.array([2, 0, 2, 1], np.int32)
    jl = jax_batched_ctx(jstack, jnp.asarray(ids), jcfg).at_layer(
        jax.tree.map(lambda t: t[0], jstack["layers"]))
    pl = batched_ctx(pstack, torch.from_numpy(ids), pcfg).at_layer(
        {k: {n: v[0] for n, v in d.items()} for k, d in pstack["layers"].items()})
    rs = np.random.RandomState(9)
    for target in pstack["layers"]:
        d_in, d_out = target_dims(pcfg, target)
        w = (rs.randn(d_in, d_out) / np.sqrt(d_in)).astype(np.float32)
        bias = rs.randn(d_out).astype(np.float32)
        for shape in ((4, d_in), (4, 5, d_in)):
            x = rs.randn(*shape).astype(np.float32)
            for bb in (None, bias):
                want = jcommon.proj(jnp.asarray(x), jnp.asarray(w),
                                    None if bb is None else jnp.asarray(bb),
                                    lora=jl, name=target)
                got = pcommon.proj(torch.from_numpy(x), torch.from_numpy(w),
                                   None if bb is None else torch.from_numpy(bb),
                                   lora=pl, name=target)
                np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)
