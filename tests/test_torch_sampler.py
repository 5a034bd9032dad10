"""The port's sampler random numbers (repro_torch.rollout.prng) against
jax.random as installed: keys, fold_in, the 32-bit random bits and the
uniforms bit-equal; the Gumbel draw within 2e-6 (torch.log and XLA's log
differ in the last bit for some inputs); _sample_rows picks the same index."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

from repro.data import tokenizer as tok
from repro.rollout.prefill import _sample_rows as jax_sample_rows
from repro_torch.rollout import prng
from repro_torch.rollout.prefill import _sample_rows

SEEDS = [0, 1, 12345, 2**31 - 1, 2**32 + 5]
COUNTERS = [0, 1, 7, 1000, 2**31 + 3]
VOCABS = [tok.VOCAB_SIZE, 257]


def _words(key):
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))


def _jax_bits(key, n):
    """jax's 32-bit random bits for a raw uint32 [2] key."""
    typed = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
    return np.asarray(jprng.random_bits(typed, 32, (n,)))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    np.testing.assert_array_equal(prng.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", COUNTERS)
def test_fold_in_bit_equal(seed, data):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.fold_in(key, data))
    got = prng.fold_in_host(np.asarray(key, np.uint32), data)
    np.testing.assert_array_equal(got, want)
    # the batched device form agrees with the host form
    rows = prng.fold_in(_words(key)[None], torch.tensor([data]))
    np.testing.assert_array_equal(rows[0].numpy().astype(np.uint32), want)


def test_fold_in_rejects_out_of_range():
    with pytest.raises(OverflowError):
        prng.fold_in_host(prng.prng_key(0), -1)


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("V", VOCABS)
def test_random_bits_and_uniform_bit_equal(seed, V):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    words = _words(key)[None]
    got_bits = prng.random_bits(words, V)[0].numpy().astype(np.uint32)
    np.testing.assert_array_equal(got_bits, _jax_bits(key, V))
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.random.uniform(key, (V,), jnp.float32,
                                           minval=tiny, maxval=1.0))
    got_u = prng.uniform(words, V)[0].numpy()
    np.testing.assert_array_equal(got_u.view(np.uint32), want_u.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("V", VOCABS)
def test_gumbel_within_log_ulp(seed, V):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    want = np.asarray(jax.random.gumbel(key, (V,), jnp.float32))
    got = prng.gumbel(_words(key)[None], V)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("temp", [1.0, 0.7, 0.0])
def test_sample_rows_same_index(V, temp):
    rs = np.random.RandomState(V)
    B = 6
    logits = (rs.randn(B, V) * 3).astype(np.float32)
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), s),
                                np.uint32) for s in range(B)])
    counters = np.array([0, 1, 2, 5, 31, 64], np.int32)
    temps = np.full((B,), temp, np.float32)
    want = np.asarray(jax_sample_rows(jnp.asarray(logits), jnp.asarray(keys),
                                      jnp.asarray(counters), jnp.asarray(temps)))
    got = _sample_rows(torch.from_numpy(logits),
                       torch.from_numpy(keys.astype(np.int64)),
                       torch.from_numpy(counters), torch.from_numpy(temps))
    np.testing.assert_array_equal(got.numpy(), want)
