"""threefry2x32 random stream, bit-identical to the installed ``jax.random``.

The reference draws every random number from JAX's threefry2x32 keys
(sampler.py:115-211, driver.py:531-637, tree.py's per-node
``fold_in(event_key, n)``).  Reproducing that stream bit for bit is what
lets the port reproduce the JAX golden rows and lets tests compare whole
pipelines event by event.

A key is an int64 tensor of shape [..., 2] holding two uint32 words (torch has
no full uint32 arithmetic, so the words live in int64 and every operation
masks with 0xFFFFFFFF).  All functions broadcast over the leading key axes.

The layout follows ``jax_threefry_partitionable=True`` (the default of the
JAX versions this repository pins): ``split`` and ``random_bits`` hash the
(hi, lo) words of a uint64 iota as the two counter lanes, and 32-bit draws
xor the two output words.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 block (20 rounds), elementwise over broadcast operands."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a 64-bit integer seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def key_from_jax(key) -> torch.Tensor:
    """A JAX raw key (uint32 pair, as a numpy array [..., 2]) -> port key."""
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))


def key_to_jax(key: torch.Tensor) -> np.ndarray:
    """Port key -> JAX raw key as a uint32 numpy array."""
    return key.cpu().numpy().astype(np.uint32)


def _hash(key, lo):
    """threefry over counters (hi=0, lo); key [..., 2], lo broadcastable."""
    k1 = key[..., 0]
    k2 = key[..., 1]
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): [..., 2] -> [..., num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = _hash(key[..., None, :], lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in(key, data), broadcasting key [..., 2] against data."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    k1 = key[..., 0]
    k2 = key[..., 1]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def _bits_pair(key, shape):
    n = int(np.prod(shape)) if len(shape) else 1
    if n >= 1 << 32:
        raise NotImplementedError("random_bits beyond 2**32 values")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = _hash(key[..., None, :], lo)
    lead = key.shape[:-1]
    return b1.reshape(lead + tuple(shape)), b2.reshape(lead + tuple(shape))


def uniform(key: torch.Tensor, shape=(), dtype=torch.float64) -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype) in [0, 1): output shape
    key.shape[:-1] + shape.  Exact: the mantissa bits are scaled by a power
    of two, as JAX's bitcast construction does."""
    b1, b2 = _bits_pair(key, shape)
    if dtype == torch.float64:
        mant = (b1 << 20) | (b2 >> 12)          # top 52 of the 64 bits
        return mant.to(torch.float64) * (2.0 ** -52)
    if dtype == torch.float32:
        mant = (b1 ^ b2) >> 9                   # top 23 of the 32 bits
        return (mant.to(torch.float64) * (2.0 ** -23)).to(torch.float32)
    raise TypeError(f"uniform: unsupported dtype {dtype}")


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            dtype=torch.int64) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval, dtype): int64, the
    dtype of an x64 JAX run, folds two 64-bit draws modulo the span; int32,
    that of a run with x64 off (the JAX CLI's --precision f32), two 32-bit
    draws."""
    span = int(maxval) - int(minval)
    if span <= 0:
        return torch.full(key.shape[:-1] + tuple(shape), int(minval),
                          dtype=dtype, device=key.device)
    if span >= 1 << 31:
        raise NotImplementedError("randint spans beyond 2**31")
    if dtype not in (torch.int64, torch.int32):
        raise TypeError(f"randint: unsupported dtype {dtype}")
    ka, kb = split(key, 2).unbind(-2)
    if dtype == torch.int32:
        mult = ((1 << 16) % span) ** 2 % span   # 2**16 % span, squared, mod span

        def mod_span(k):
            b1, b2 = _bits_pair(k, shape)   # the 32-bit draw xors the two words
            return (b1 ^ b2) % span
    else:
        p32 = (1 << 32) % span
        mult = ((1 << 32) % span) ** 2 % span   # 2**32 % span, squared, mod span

        def mod_span(k):
            hi, lo = _bits_pair(k, shape)       # value = hi * 2**32 + lo
            return ((hi % span) * p32 + lo % span) % span

    off = (mod_span(ka) * mult + mod_span(kb)) % span
    return (off + int(minval)).to(dtype)
