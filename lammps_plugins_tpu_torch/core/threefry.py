"""Threefry-2x32 counter-based random numbers, draw for draw those of
jax.random (jax._src.prng: threefry_seed, threefry_2x32,
threefry_fold_in, _threefry_random_bits_partitionable; jax._src.random:
_uniform), written as torch integer ops so that fix langevin draws on
the card, inside a captured graph, the noise the JAX package draws.

The words are uint32 held in int64 tensors and masked to 32 bits after
every add (torch's uint32 lacks shifts on some backends).  Random bits
follow JAX's partitionable layout (jax_threefry_partitionable, the
default since JAX 0.5): element e of the output hashes the 64-bit
counter e split into (hi, lo) words; 32-bit draws take hi ^ lo of the
hash, 64-bit draws hi << 32 | lo.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key (k1, k2); keys are Python ints or int64 tensors, all values in
    [0, 2^32)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple:
    """jax.random.PRNGKey(seed): the seed's 64-bit pattern as (hi, lo)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & MASK, seed & MASK


def fold_in(key, data: torch.Tensor) -> tuple:
    """jax.random.fold_in(key, data) for an integer 0-d tensor `data`
    (taken modulo 2^32, as JAX casts it to uint32): the key hashed at the
    counter (0, data)."""
    d = data.to(torch.int64) & MASK
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def random_bits(key, shape, device, wide: bool = False):
    """JAX's partitionable random bits of `shape`: (hi ^ lo) for 32-bit
    words, or the pair (hi, lo) of each 64-bit word when wide."""
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32(key[0], key[1], count >> 32, count & MASK)
    if wide:
        return hi.reshape(shape), lo.reshape(shape)
    return (hi ^ lo).reshape(shape)


def uniform(key, shape, dtype=torch.float64, minval=0.0, maxval=1.0,
            device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype, minval, maxval): random
    mantissa bits under the exponent of 1.0, minus 1, scaled and shifted
    in `dtype`, then floored at minval (float32 and float64)."""
    if dtype == torch.float32:
        bits = random_bits(key, shape, device)
        fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
        floats = fbits.view(torch.float32) - 1.0
    elif dtype == torch.float64:
        hi, lo = random_bits(key, shape, device, wide=True)
        fbits = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
        floats = fbits.view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform: float32 or float64, not {dtype}")
    # the bounds as Python numbers rounded to `dtype` (a captured graph
    # may not copy a host tensor to the card)
    as_dt = np.float32 if dtype == torch.float32 else np.float64
    lo = as_dt(minval)
    span = float(as_dt(maxval) - lo)
    return torch.clamp(floats * span + float(lo), min=float(lo))
