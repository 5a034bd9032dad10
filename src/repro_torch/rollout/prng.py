"""The sampler's random numbers, matching ``jax.random`` (threefry2x32 with
``jax_threefry_partitionable=True``, the default of jax 0.9) so that the port
samples the JAX package's tokens from the same logits.

It reads, from jax's ``_src/prng.py`` and ``_src/random.py``:
  - ``threefry2x32``: 20 rounds of the Threefry-2x32 block cipher;
  - ``PRNGKey(seed)`` = ``[0, seed mod 2**32]`` (jax without x64);
  - ``fold_in(key, d)`` = ``threefry2x32(key, [0, d])``;
  - ``random_bits(key, (n,))`` = ``bits1 ^ bits2`` of
    ``threefry2x32(key, (hi, lo))`` over the 64-bit counters ``0..n-1``;
  - ``_uniform`` in float32 with ``minval = tiny``: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, plus tiny;
  - ``_gumbel`` (mode "low") = ``-log(-log(u))``;
  - ``categorical(key, logits)`` = ``argmax(gumbel + logits)``.

torch has no uint32 arithmetic, so every 32-bit word is held in an int64
tensor and masked after each add and shift. Keys, bits and uniforms are
bit-exact; the Gumbel noise goes through ``torch.log``, which differs from
XLA's ``log`` in the last bit for some inputs, so it agrees to about 1e-6.
The non-partitionable layout (the default of jax 0.4.x) is not implemented.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


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
    """32-bit random words, [B, n] int64, one row per key of keys [B, 2]."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y1, y2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return y1 ^ y2


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
