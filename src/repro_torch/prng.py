"""The port's copy of the ``jax.random`` semantics the serving path samples
with: ``PRNGKey``, ``fold_in``, the threefry2x32 block, ``random_bits``,
``uniform``, ``gumbel`` and ``categorical`` (Gumbel-max over the last
axis).

The choice is **equal sampled tokens**: a request sampled by the port under
a seed draws the same bits, and so the same tokens wherever its logits
agree, as the JAX package under that seed.  The layout followed is JAX's
with ``jax_threefry_partitionable`` on (the default of the JAX releases
this repo runs, 0.5 on): the bits of a draw of shape ``s`` under key
``(k1, k2)`` are ``b1 ^ b2`` of ``threefry2x32(k1, k2, hi, lo)``, where
``(hi, lo)`` is the 64-bit row-major index of each element split in two
32-bit words.

A key is an int64 tensor whose last axis holds the two 32-bit words, each
in [0, 2^32): int64 with every sum and shift masked to 32 bits runs the
same on the CPU and on the card, where not every op takes ``torch.uint32``.
Keys may carry leading batch axes; a batch of keys draws one row each, as
``jax.vmap`` over the JAX functions does.

Floats follow ``jax.random``: 23 random mantissa bits under the exponent of
1.0, minus 1, for ``uniform``; ``gumbel`` is ``-log(-log(u))`` of a uniform
on [tiny, 1).  Each log here is taken in float64 and rounded to float32,
so it is the correctly rounded float32 log on every device; JAX's float32
log may differ from it in the last place on rare inputs, which moves a
token only where two scores tie within that place.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block (20 rounds) on 32-bit words held in int64
    tensors (broadcast together) → (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX name)
    """``jax.random.PRNGKey(seed)`` → (2,) int64.  The seed is read as the
    JAX package reads it with 64-bit types off: a 32-bit integer, so the
    key is ``(0, seed mod 2^32)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or an integer
    tensor broadcasting against the key's batch axes → (..., 2)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:       # no host-to-device copy: the step loop must not sync
        data = torch.full((), int(data) & MASK, dtype=torch.int64,
                          device=key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits (int64 in [0, 2^32)) of ``shape`` under each key of
    ``key`` (..., 2) → (..., *shape)."""
    shape = tuple(int(n) for n in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 → (..., *shape)."""
    bits = random_bits(key, shape)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32 → (..., *shape)."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0)
    inner = torch.log(u.double()).float()
    return -torch.log(-inner.double()).float()


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: key (..., 2), logits
    (..., V) float32 → (...,) int64, the first index of the largest
    Gumbel-perturbed logit."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
