"""The port's sampler in both threefry layouts against jax as installed.

jax's ``jax_threefry_partitionable`` picks how ``random_bits`` lays its
counters out (True by default since jax 0.5, False in jax 0.4.x, which
``pyproject.toml`` pins). The port mirrors it with
``repro_torch.rollout.prng.THREEFRY_PARTITIONABLE`` and the context manager
``prng.threefry_partitionable(flag)``. Every test here runs in both layouts,
with jax and the port set alike by the ``layout`` fixture, which restores both
settings when the test ends, failed or not (later files run in the same
worker): the raw draws bit-equal (Gumbel within 2e-6, as in
``test_torch_sampler.py``), ``_sample_rows`` the same indices, and
``RolloutEngine.generate`` the same token streams as the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

from conftest import tiny_lm
from repro.rollout.engine import RolloutEngine
from repro.rollout.prefill import _sample_rows as jax_sample_rows
from repro_torch.rollout import prng
from repro_torch.rollout.engine import RolloutEngine as PtEngine
from repro_torch.rollout.prefill import _sample_rows
from test_torch_engine import _port_cfg, _requests, _setup
from test_torch_sampler import COUNTERS, SEEDS, _jax_bits

VOCABS = [5, 257, 49155, 151936]     # 49155 (odd): granite's tokenizer
JAX_DEFAULT = bool(jax.config.jax_threefry_partitionable)
TINY = np.finfo(np.float32).tiny


@pytest.fixture(params=[True, False], ids=["partitionable", "legacy"])
def layout(request):
    flag = request.param
    try:
        with jax.threefry_partitionable(flag), prng.threefry_partitionable(flag):
            assert prng.THREEFRY_PARTITIONABLE is flag
            yield flag
    finally:
        assert bool(jax.config.jax_threefry_partitionable) is JAX_DEFAULT
        assert prng.THREEFRY_PARTITIONABLE is True


def _keys():
    """One key a (seed, counter) of test_torch_sampler.py: [25, 2] uint32."""
    return np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), c),
                                np.uint32)
                     for s in SEEDS for c in COUNTERS])


def test_context_manager_restores_on_error():
    with pytest.raises(RuntimeError):
        with prng.threefry_partitionable(False):
            assert prng.THREEFRY_PARTITIONABLE is False
            raise RuntimeError
    assert prng.THREEFRY_PARTITIONABLE is True


def test_keys_and_fold_in_are_the_same_in_both_layouts(layout):
    for s in SEEDS:
        key = jax.random.PRNGKey(s)
        np.testing.assert_array_equal(prng.prng_key(s), np.asarray(key))
        for c in COUNTERS:
            np.testing.assert_array_equal(
                prng.fold_in_host(np.asarray(key, np.uint32), c),
                np.asarray(jax.random.fold_in(key, c)))


def _jax_draws(keys, V):
    """jax's random bits and uniforms, key by key (vmapped), in the layout
    set when called (a fresh function each call: no trace is reused)."""
    def one(k):
        return (jprng.random_bits(jax.random.wrap_key_data(k), 32, (V,)),
                jax.random.uniform(k, (V,), jnp.float32, minval=TINY,
                                   maxval=1.0))
    bits, uni = jax.jit(jax.vmap(one))(jnp.asarray(keys))
    return np.asarray(bits), np.asarray(uni)


@pytest.mark.parametrize("V", VOCABS)
def test_random_bits_and_uniform_bit_equal(layout, V):
    keys = _keys()
    words = torch.from_numpy(keys.astype(np.int64))
    want_bits, want_uni = _jax_draws(keys, V)
    np.testing.assert_array_equal(
        prng.random_bits(words, V).numpy().astype(np.uint32), want_bits)
    np.testing.assert_array_equal(prng.uniform(words, V).numpy().view(np.uint32),
                                  want_uni.view(np.uint32))
    # and the unbatched jax function on one key
    np.testing.assert_array_equal(want_bits[-1], _jax_bits(keys[-1], V))


@pytest.mark.parametrize("V", VOCABS)
def test_gumbel_within_log_ulp(layout, V):
    keys = _keys()[::4]
    got = prng.gumbel(torch.from_numpy(keys.astype(np.int64)), V).numpy()
    for i, k in enumerate(keys):
        want = np.asarray(jax.random.gumbel(jnp.asarray(k), (V,), jnp.float32))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=2e-6)


def _sample_case(V, temp):
    rs = np.random.RandomState(V)
    B = 6
    logits = (rs.randn(B, V) * 3).astype(np.float32)
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), s),
                                np.uint32) for s in range(B)])
    counters = np.array([0, 1, 2, 5, 31, 64], np.int32)
    temps = np.full((B,), temp, np.float32)
    return logits, keys, counters, temps


@pytest.mark.parametrize("V", [257, 49155])
@pytest.mark.parametrize("temp", [1.0, 0.7])
def test_sample_rows_same_index(layout, V, temp):
    logits, keys, counters, temps = _sample_case(V, temp)
    want = np.asarray(jax_sample_rows(jnp.asarray(logits), jnp.asarray(keys),
                                      jnp.asarray(counters), jnp.asarray(temps)))
    got = _sample_rows(torch.from_numpy(logits),
                       torch.from_numpy(keys.astype(np.int64)),
                       torch.from_numpy(counters), torch.from_numpy(temps))
    np.testing.assert_array_equal(got.numpy(), want)


def _served_round(jcfg, pcfg, weights):
    jparams, jtrees, pparams, ptrees = weights
    jreqs, preqs = _requests(4, 2)
    res_j, _ = RolloutEngine(jcfg, jparams, max_len=64, seed=0).generate(
        jreqs, jtrees)
    res_p, _ = PtEngine(pcfg, pparams, max_len=64, seed=0,
                        device="cpu").generate(preqs, ptrees)
    return [r["tokens"] for r in res_j], [r["tokens"] for r in res_p]


def test_generate_matches_jax_engine_and_the_layout_reaches_the_sampler():
    """One served round on tiny_lm() in each layout: the port's streams equal
    the JAX engine's in the same layout, and differ between the layouts."""
    jcfg, pcfg = tiny_lm("granite-3-2b"), _port_cfg("granite-3-2b", True)
    weights = _setup(jcfg, pcfg)      # drawn once, in jax's default layout
    streams = {}
    for flag in (True, False):
        with jax.threefry_partitionable(flag), prng.threefry_partitionable(flag):
            jax_toks, port_toks = _served_round(jcfg, pcfg, weights)
        assert port_toks == jax_toks, f"partitionable={flag}"
        streams[flag] = port_toks
    assert streams[True] != streams[False]
    assert bool(jax.config.jax_threefry_partitionable) is JAX_DEFAULT
    assert prng.THREEFRY_PARTITIONABLE is True
