"""The sampler's random numbers, matching ``jax.random`` (threefry2x32) so
that the port samples the JAX package's tokens from the same logits.

It reads, from jax's ``_src/prng.py`` and ``_src/random.py``:
  - ``threefry2x32``: 20 rounds of the Threefry-2x32 block cipher;
  - ``PRNGKey(seed)`` = ``[0, seed mod 2**32]`` (jax without x64);
  - ``fold_in(key, d)`` = ``threefry2x32(key, [0, d])``;
  - ``random_bits(key, (n,))`` in the layout jax's
    ``jax_threefry_partitionable`` names (below);
  - ``_uniform`` in float32 with ``minval = tiny``: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, plus tiny;
  - ``_gumbel`` (mode "low") = ``-log(-log(u))``;
  - ``categorical(key, logits)`` = ``argmax(gumbel + logits)``.

The two layouts of ``random_bits``, which only it depends on (keys and
``fold_in`` are the same in both):
  - partitionable (``THREEFRY_PARTITIONABLE = True``, the default, as in
    jax >= 0.5): ``bits1 ^ bits2`` of ``threefry2x32(key, (hi, lo))`` over
    the 64-bit counters ``0..n-1``;
  - non-partitionable (``False``, the default of jax 0.4.x): the counters
    ``0..n-1`` with one 0 appended when n is odd (m = n rounded up to
    even), ``(y1, y2) = threefry2x32(key, x[:m/2], x[m/2:])``, and the words
    ``concat(y1, y2)[:n]`` (n < 2**32 - 1, one block of counters).
The setting mirrors jax's process-wide ``jax_threefry_partitionable``:
``random_bits`` reads it at call time, and ``threefry_partitionable(flag)``
sets it for a ``with`` block and restores it. Unlike jax's context manager
it is not thread-local: the engines' decode thread and the prefill workers
all read the one value, so set it before building an engine and leave it
while the engine runs.

torch has no uint32 arithmetic, so every 32-bit word is held in an int64
tensor and masked after each add and shift. Keys, bits and uniforms are
bit-exact in both layouts, on the CPU and on the card; the Gumbel noise goes
through ``torch.log``, which differs from XLA's ``log`` in the last bit for
some inputs, so it agrees to about 1e-6.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)

THREEFRY_PARTITIONABLE = True   # jax_threefry_partitionable (jax >= 0.5)


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """``jax.threefry_partitionable(flag)``: ``random_bits``' layout inside
    the block, restored after it (process-wide, not per thread)."""
    global THREEFRY_PARTITIONABLE
    old, THREEFRY_PARTITIONABLE = THREEFRY_PARTITIONABLE, bool(flag)
    try:
        yield
    finally:
        THREEFRY_PARTITIONABLE = old


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 over int64 tensors holding uint32 words (k1, k2 may be
    Python ints or tensors broadcastable against x1, x2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a uint32 [2] array."""
    return np.array([0, int(seed) & _M32], np.uint32)


def fold_in(keys, data):
    """``jax.random.fold_in`` row by row. keys: [..., 2] int64 words;
    data: [...] integers in [0, 2**32). Returns [..., 2] int64 words."""
    k1, k2 = keys[..., 0], keys[..., 1]
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(data), data & _M32)
    return torch.stack([y1, y2], dim=-1)


def fold_in_host(key: np.ndarray, data: int) -> np.ndarray:
    """``fold_in`` of one uint32 [2] key on the host."""
    if not 0 <= int(data) <= _M32:
        raise OverflowError(f"fold_in data {data} is outside uint32")
    out = fold_in(torch.from_numpy(key.astype(np.int64)),
                  torch.tensor(int(data), dtype=torch.int64))
    return out.numpy().astype(np.uint32)


def random_bits(keys, n: int):
    """32-bit random words, [B, n] int64, one row per key of keys [B, 2], in
    the layout ``THREEFRY_PARTITIONABLE`` names when called."""
    k1, k2 = keys[:, :1], keys[:, 1:]
    if THREEFRY_PARTITIONABLE:
        lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
        y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
        return y1 ^ y2
    half = (n + 1) // 2
    x = torch.arange(2 * half, dtype=torch.int64, device=keys.device)
    x = torch.where(x < n, x, 0)[None, :]       # odd n: one 0 appended
    y1, y2 = threefry2x32(k1, k2, x[:, :half], x[:, half:])
    return torch.cat([y1, y2], dim=1)[:, :n]


def uniform(keys, n: int):
    """``jax.random.uniform(key, (n,), float32, minval=tiny)`` per row."""
    bits = random_bits(keys, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel(keys, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") per row."""
    return -torch.log(-torch.log(uniform(keys, n)))


def categorical(keys, logits):
    """``jax.random.categorical(key, logits)`` per row: argmax of logits plus
    Gumbel noise. keys: [B, 2] int64 words; logits: [B, V] float32."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
