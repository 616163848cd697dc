"""Threefry-2x32 and jax.random's key splitting, in Python integers.

The JAX package derives its RANSAC seeds from jax.random keys
(stella_vslam_tpu/module/initializer.py:118,179; ops/solve/ransac.py:21).
This copy reproduces that stream without JAX: a key is a pair of uint32
words, PRNGKey(s) is (0, s) for 0 <= s < 2**32, and under the partitionable
Threefry layout (jax_threefry_partitionable, the default since jax 0.5)
split(key, n)[i] is the Threefry-2x32 block of `key` at the counter (0, i).
The block cipher is Salmon et al., "Parallel random numbers: as easy as 1, 2,
3" (SC 2011), with 20 rounds, as jax._src.prng implements it.
"""
from __future__ import annotations

from typing import List, Tuple

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, d: int) -> int:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(key: Key, count: Key) -> Key:
    """The 20-round Threefry-2x32 block of `key` at the counter `count`."""
    ks = (key[0] & _M32, key[1] & _M32, (key[0] ^ key[1] ^ 0x1BD11BDA) & _M32)
    x0 = (count[0] + ks[0]) & _M32
    x1 = (count[1] + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**32."""
    return (0, seed & _M32)


def split(key: Key, n: int) -> List[Key]:
    """jax.random.split(key, n) under the partitionable layout."""
    return [threefry2x32(key, (0, i)) for i in range(n)]


def key_seed(key: Key) -> int:
    """The uint32 seed the JAX package's RANSAC takes from a key: the sum of
    its words (ops/solve/ransac.py _seed_from_key)."""
    return (key[0] + key[1]) & _M32
