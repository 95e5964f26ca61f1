"""Threefry-2x32 random draws, bit for bit those of ``jax.random``.

The reference draws every random number of the TNN (initial weights, STDP
uniforms, the training key chain) with ``jax.random`` on its default
threefry implementation, with ``jax_threefry_partitionable`` on (the default
of jax 0.9.0). The functions here reproduce those draws exactly:

* a key is a pair of uint32 words, a ``torch.uint32`` tensor of shape (2,)
  (or (..., 2) for a batch of keys); :func:`PRNGKey` ``(seed)`` is
  ``(0, seed mod 2**32)``;
* :func:`split` ``(key, n)[i]`` is ``threefry2x32(key, (0, i))``;
* :func:`random_bits` gives flat element ``j`` of a shape the word
  ``b1 ^ b2`` of ``threefry2x32(key, (j >> 32, j & 0xffffffff))``: the
  counter is the 64-bit iota over the row-major shape;
* :func:`uniform` turns those bits into float32 in [0, 1) by the bit
  pattern ``(bits >> 9) | 0x3f800000`` minus 1.0;
* :func:`randint` follows ``jax._src.random._randint``: the key splits in
  two, each half gives 32 random bits (types narrower than 32 bits are
  sampled at 32 bits, then cast), combined through the span multiplier.

These are plain PyTorch functions: the arithmetic is ``torch.int64`` masked to
32 bits, on the device of the call (the host by default). Key chains are a few
words and run on the host. The STDP uniforms of a whole layer, the one large
draw of a learning wave, have a hand-written kernel,
``kernels.threefry.layer_uniforms``, whose plain version is
:func:`uniform` over the layer's column keys.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

KeyLike = Union[torch.Tensor, np.ndarray, Sequence[int]]


def as_key(key: KeyLike) -> torch.Tensor:
    """``key`` (a torch or numpy array of uint32 words, or a pair of ints)
    as a host ``torch.uint32`` tensor of shape (..., 2)."""
    if isinstance(key, torch.Tensor):
        k = key.detach().to("cpu")
        if k.dtype != torch.uint32:
            k = k.to(torch.int64)
            if int(k.min()) < 0 or int(k.max()) > M32:
                raise ValueError("key words must lie in [0, 2**32)")
            k = k.to(torch.uint32)
    else:
        a = np.asarray(key)
        if not np.issubdtype(a.dtype, np.integer):
            raise TypeError(f"key words must be integers, got {a.dtype}")
        if a.size and (a.min() < 0 or a.max() > M32):
            raise ValueError("key words must lie in [0, 2**32)")
        k = torch.from_numpy(a.astype(np.uint32))
    if k.dim() == 0 or k.shape[-1] != 2:
        raise ValueError(f"a key is (..., 2) uint32 words, got shape {tuple(k.shape)}")
    return k


def key_words(key: KeyLike) -> Tuple[int, int]:
    """The two words of one key as Python ints."""
    k = as_key(key)
    if k.dim() != 1:
        raise ValueError(f"one key is (2,), got {tuple(k.shape)}")
    w = k.tolist()
    return int(w[0]), int(w[1])


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 (the reference's name)
    """The key of an integer seed, as ``jax.random.PRNGKey(seed)`` with 64-bit
    types off (the reference's setting): the seed is taken as a 32-bit
    integer, so the key is ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64).to(torch.uint32)


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2). Every argument is an int64 tensor (or int)
    of values in [0, 2**32), all broadcast together; returns the two output
    words as int64 tensors in the same range. The rounds run in place on
    two buffers (a large draw is ~100 passes over them)."""
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    k2 = torch.as_tensor(k2, dtype=torch.int64)
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    a, b = torch.broadcast_tensors((x1 + ks[0]) & M32, (x2 + ks[1]) & M32)
    a, b = a.contiguous(), b.contiguous()
    t = torch.empty_like(b)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(M32)
            # b = rotl(b, r) ^ a
            torch.bitwise_left_shift(b, r, out=t).bitwise_and_(M32)
            b.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        b.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(M32)
    return a, b


def _key_pair(key: KeyLike, device) -> Tuple[torch.Tensor, torch.Tensor]:
    k = as_key(key).to(torch.int64).to(device)
    return k[..., 0], k[..., 1]


def _threefry_words(k1: int, k2: int, x1: int, x2: int) -> Tuple[int, int]:
    """:func:`threefry2x32` of one counter pair on Python ints: a key chain's
    few hashes without a tensor op each (a split of one key into two is
    about a hundred ops as tensors, a millisecond of host time)."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    a, b = (x1 + k1) & M32, (x2 + k2) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = (((b << r) & M32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


SMALL_SPLIT = 64  # splits of one key into at most this many run on Python ints


def split(key: KeyLike, num: int = 2) -> torch.Tensor:
    """``num`` new keys, (num, 2) uint32, as ``jax.random.split(key, num)``:
    key ``i`` is ``threefry2x32(key, (0, i))``. A batch of keys (..., 2)
    gives (..., num, 2), as a vmap of the split over the keys."""
    k = as_key(key)
    if k.dim() == 1 and num <= SMALL_SPLIT:
        k1, k2 = key_words(k)
        words = [_threefry_words(k1, k2, 0, i) for i in range(num)]
        return torch.tensor(words, dtype=torch.int64).reshape(num, 2).to(torch.uint32)
    k1, k2 = _key_pair(k, "cpu")
    i = torch.arange(num, dtype=torch.int64)
    a, b = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1).to(torch.uint32)


def random_bits(key: KeyLike, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """32 random bits per element of ``shape`` as int64 in [0, 2**32):
    ``b1 ^ b2`` of the threefry of the element's 64-bit row-major index.
    A batch of keys (..., 2) gives (..., *shape), each key over its own
    index from 0 (what ``jax.vmap`` of the draw over the keys gives)."""
    k1, k2 = _key_pair(key, device)
    n = math.prod(shape)
    j = torch.arange(n, dtype=torch.int64, device=device)
    lead = k1.dim()
    k1 = k1.reshape(*k1.shape, 1)
    k2 = k2.reshape(*k2.shape, 1)
    a, b = threefry2x32(k1, k2, j >> 32, j & M32)
    return (a ^ b).reshape(*k1.shape[:lead], *shape)


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64 in [0, 2**32)) -> float32 in [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    pattern = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return pattern.view(torch.float32) - 1.0


def uniform(key: KeyLike, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape``, as
    ``jax.random.uniform(key, shape, dtype=float32)``; a batch of keys
    (..., 2) gives (..., *shape), as a vmap of the draw over the keys."""
    return bits_to_unit_float(random_bits(key, shape, device))


_NARROW = {torch.int8: 8, torch.uint8: 8, torch.int16: 16, torch.int32: 32}


def randint(key: KeyLike, shape: Sequence[int], minval: int, maxval: int,
            dtype: torch.dtype = torch.int32, device="cpu") -> torch.Tensor:
    """Integers in [minval, maxval) of ``shape``, as
    ``jax.random.randint(key, shape, minval, maxval, dtype)`` for integer
    types of at most 32 bits (sampled at 32 bits, as the reference samples
    them, then cast); a batch of keys (..., 2) gives (..., *shape)."""
    if dtype not in _NARROW:
        raise TypeError(f"randint takes {sorted(map(str, _NARROW))}, not {dtype}")
    info = torch.iinfo(dtype)
    # the reference clips the bounds to the requested type, then samples int32
    lo = min(max(int(minval), info.min), info.max)
    hi = min(max(int(maxval), info.min), info.max + 1)
    halves = split(key)                  # (..., 2, 2): the two halves' keys
    higher = random_bits(halves[..., 0, :], shape, device)
    lower = random_bits(halves[..., 1, :], shape, device)
    span = (hi - lo) & M32 if hi > lo else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    offset = (((higher % span) * mult) & M32) + (lower % span)
    offset = (offset & M32) % span
    # int32 add of minval and the offset, as the reference's lax.add
    out = (lo + offset + 2 ** 31) % 2 ** 32 - 2 ** 31
    return out.to(torch.int32).to(dtype)
