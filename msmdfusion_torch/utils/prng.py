"""``jax.random.uniform``'s bits without JAX: threefry-2x32 and the
float conversion of the JAX package's pinned JAX (0.9.0).

The GMA encoder's ``MSMD_GMA_DUMMY=random:<seed>`` ablation draws its
dummy row with ``jax.random.uniform(jax.random.PRNGKey(seed * 8 + i),
(c3,))`` (JAX ``gma_encoder.py:186-190``); ``uniform`` here returns the
same float32 values. What it follows, from JAX's sources:

- ``PRNGKey(seed)`` is the pair (seed >> 32, seed & 0xFFFFFFFF)
  (``prng.py`` ``_threefry_seed``);
- with ``jax_threefry_partitionable`` (True from JAX 0.5.0 on) the 32
  random bits of flat element n are ``x0 ^ x1`` of threefry2x32(key,
  (n >> 32, n & 0xFFFFFFFF)) (``prng.py:1184-1200``, ``iota_2x32_shape``);
- threefry2x32 is Random123's 20-round Threefry-2x32 with a key
  injection every 4 rounds (``_threefry2x32_lowering``);
- a float32 in [0, 1) is ``bitcast((bits >> 9) | 0x3F800000) - 1``,
  scaled to [minval, maxval) and floored at minval (``random.py``
  ``_uniform``).

It runs in int64 arithmetic on the CPU (the rows are a few hundred
values) and hands the result to the caller's device.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs (``x0``, ``x1``),
    int64 tensors of uint32 values, under the key (``k0``, ``k1``)."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def random_bits(seed: int, n: int):
    """The [n] uint32 values (as int64) of ``jax.random.bits(PRNGKey(seed),
    (n,))``."""
    count = torch.arange(n, dtype=torch.int64)
    x0, x1 = threefry2x32(seed >> 32, seed, count >> 32, count & _MASK)
    return x0 ^ x1


def uniform(seed: int, n: int, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(seed), (n,), minval=minval,
    maxval=maxval)``, bit for bit, as a float32 tensor on ``device``."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f'seed {seed}: expected 0 <= seed < 2**31 (an '
                         'int32 seed, as JAX takes it without x64)')
    one = (random_bits(seed, n) >> 9) | 0x3F800000     # < 2^31: int32 safe
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo, floats * (hi - lo) + lo).to(device)
