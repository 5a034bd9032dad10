"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode and its ref.py oracles,
across the sweeps of tests/test_kernels.py. Inputs are made with numpy and
fed to both. Tolerances as in the JAX tests: fp32 1e-5 relative (sgmv, 1e-4
absolute) and 2e-5 for attention, bf16 3e-2.

The CUDA kernels themselves run only on the card: chip_smoke.py and
tests/test_torch_cuda.py hold them against these plain versions there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.gqa_decode import gqa_decode as jax_gqa_decode
from repro.kernels.sgmv import sgmv as jax_sgmv
from repro_torch.kernels import ops
from repro_torch.kernels import gqa_decode as gqa_mod
from repro_torch.kernels import sgmv as sgmv_mod


def _both(a, dtype):
    """(jax array, torch tensor) of the same values in `dtype`."""
    if dtype == "bf16":
        j = jnp.asarray(a, jnp.bfloat16)
        t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        return j, t
    return jnp.asarray(a, jnp.float32), torch.from_numpy(np.asarray(a, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("R,d,r,dout,T", [
    (32, 64, 8, 48, 3), (100, 256, 16, 512, 5), (17, 48, 4, 40, 2),
    (64, 128, 32, 256, 8), (8, 72, 8, 72, 1), (256, 64, 8, 64, 16),
])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_sgmv_sweep(R, d, r, dout, T, dtype):
    rs = np.random.RandomState(R + d)
    x = rs.randn(R, d).astype(np.float32)
    a = (rs.randn(T, d, r) * 0.1).astype(np.float32)
    b = (rs.randn(T, r, dout) * 0.1).astype(np.float32)
    ids = rs.randint(0, T, size=R).astype(np.int32)
    (jx, tx), (ja, ta), (jb, tb) = (_both(v, dtype) for v in (x, a, b))
    got = ops.sgmv(tx, ta, tb, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (R, dout)
    tol = 1e-5 if dtype is np.float32 else 3e-2
    for want in (jax_sgmv(jx, ja, jb, jnp.asarray(ids)),
                 jref.sgmv_ref(jx, ja, jb, jnp.asarray(ids))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 10)


def test_sgmv_empty_group():
    """Tasks with zero rows must not corrupt neighbours."""
    rs = np.random.RandomState(0)
    x = rs.randn(24, 32).astype(np.float32)
    a = (rs.randn(4, 32, 4) * 0.1).astype(np.float32)
    b = (rs.randn(4, 4, 16) * 0.1).astype(np.float32)
    ids = np.array([0] * 12 + [3] * 12, np.int32)      # groups 1, 2 empty
    got = ops.sgmv(*(torch.from_numpy(v) for v in (x, a, b, ids)))
    for want in (jax_sgmv(*(jnp.asarray(v) for v in (x, a, b, ids))),
                 jref.sgmv_ref(*(jnp.asarray(v) for v in (x, a, b, ids)))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # the empty groups' adapters play no part: change them, same output
    a2, b2 = a.copy(), b.copy()
    a2[1:3] = 7.0
    b2[1:3] = -7.0
    got2 = ops.sgmv(*(torch.from_numpy(v) for v in (x, a2, b2, ids)))
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("B,H,KVH,hd,S", [
    (2, 4, 2, 16, 64), (3, 8, 2, 32, 128), (2, 4, 4, 16, 64),
    (1, 12, 2, 16, 96), (2, 16, 8, 64, 256),
])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 24)])
def test_gqa_decode_sweep(B, H, KVH, hd, S, softcap, window):
    rs = np.random.RandomState(B * S + H)
    q = rs.randn(B, H, hd).astype(np.float32)
    ck = rs.randn(B, S, KVH, hd).astype(np.float32)
    cv = rs.randn(B, S, KVH, hd).astype(np.float32)
    pos = rs.randint(1, S, size=B).astype(np.int32)
    got = ops.gqa_decode(*(torch.from_numpy(v) for v in (q, ck, cv, pos)),
                         softcap=softcap, window=window)
    jin = [jnp.asarray(v) for v in (q, ck, cv, pos)]
    for want in (jax_gqa_decode(*jin, bs=32, softcap=softcap, window=window),
                 jref.gqa_decode_ref(*jin, softcap=softcap, window=window)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_gqa_decode_bf16_cache():
    rs = np.random.RandomState(1)
    q, ck, cv = (rs.randn(*s).astype(np.float32)
                 for s in ((2, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    pos = np.array([13, 64], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(v, "bf16") for v in (q, ck, cv))
    got = ops.gqa_decode(tq, tk, tv, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    for want in (jax_gqa_decode(jq, jk, jv, jnp.asarray(pos), bs=32),
                 jref.gqa_decode_ref(jq, jk, jv, jnp.asarray(pos))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2, atol=3e-2)


def test_cpu_wrappers_do_not_count_launches():
    """The launch counters move only where a CUDA kernel launches."""
    n_g, n_s = gqa_mod.LAUNCHES.n, sgmv_mod.LAUNCHES.n
    q = torch.zeros(1, 2, 32)
    ops.gqa_decode(q, torch.zeros(1, 8, 1, 32), torch.zeros(1, 8, 1, 32),
                   torch.ones(1, dtype=torch.int32))
    ops.sgmv(torch.zeros(2, 8), torch.zeros(1, 8, 4), torch.zeros(1, 4, 8),
             torch.zeros(2, dtype=torch.int32))
    assert (gqa_mod.LAUNCHES.n, sgmv_mod.LAUNCHES.n) == (n_g, n_s)

