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
  pattern ``(bits >> 9) | 0x3f800000`` minus 1.0, then maps them to
  [minval, maxval) as ``max(minval, fma(floats, maxval - minval, minval))``;
* :func:`normal` is ``sqrt(2) * erf_inv(u)`` of a uniform on
  [nextafter(-1, 0), 1), with :func:`erf_inv` the f32 ErfInv that XLA's CPU
  backend compiles for ``jax.random.normal`` (see :func:`erf_inv`);
* :func:`randint` follows ``jax._src.random._randint``: the key splits in
  two, each half gives 32 random bits (types narrower than 32 bits are
  sampled at 32 bits, then cast), combined through the span multiplier.

These are plain PyTorch functions: the arithmetic is ``torch.int64`` masked to
32 bits, on the device of the call (the host by default); the float steps of
:func:`normal` are each one IEEE-exact operation (+, -, *, /, sqrt, and a
fused multiply-add computed exactly in float64), so the host and the card
give the same bits. Key chains are a few
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


def random_bits(key: KeyLike, shape: Sequence[int], device="cpu", *,
                offset: int = 0) -> torch.Tensor:
    """32 random bits per element of ``shape`` as int64 in [0, 2**32):
    ``b1 ^ b2`` of the threefry of the element's 64-bit row-major index.
    A batch of keys (..., 2) gives (..., *shape), each key over its own
    index from 0 (what ``jax.vmap`` of the draw over the keys gives).
    ``offset`` shifts every index: the draw is then the window
    ``[offset, offset + prod(shape))`` of a longer draw's flat bits, so a
    large draw can be made in chunks."""
    k1, k2 = _key_pair(key, device)
    n = math.prod(shape)
    j = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
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


def uniform(key: KeyLike, shape: Sequence[int], device="cpu", *,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval) of ``shape``, as
    ``jax.random.uniform(key, shape, float32, minval, maxval)``; a batch of
    keys (..., 2) gives (..., *shape), as a vmap of the draw over the keys."""
    floats = bits_to_unit_float(random_bits(key, shape, device))
    if (minval, maxval) == (0.0, 1.0):
        return floats      # the map below is the identity on [0, 1)
    return unit_to_range(floats, minval, maxval)


def _f32(bits: int) -> float:
    """The float32 of a bit pattern, as a Python float (exact)."""
    return float(np.array(bits, np.uint32).view(np.float32))


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a hardware FMA: float32
    tensors (or numbers) in, float32 out. The product of two float32 is
    exact in float64; the sum is rounded to odd in float64 (its TwoSum error
    decides the last bit), and a round to odd at 53 bits followed by one
    round to 24 is the correctly rounded result."""
    ref = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = (torch.as_tensor(t, dtype=torch.float32, device=ref.device).double()
               for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def unit_to_range(floats: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """float32 in [0, 1) -> [minval, maxval), as ``jax.random.uniform``
    maps them: the span ``maxval - minval`` in float32, then
    ``max(minval, floats * span + minval)`` with the product and the sum
    fused (XLA's CPU backend emits one FMA for them)."""
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    lo = lo.to(floats.device)
    return torch.maximum(lo, fma32(floats, span.to(floats.device), lo))


# log1p(t) for |t| < sqrt(2) - 1: t - t*t/2 + t**3 * N(t) / Q(t), the
# coefficients of N (degree 6, highest first) and of Q (monic, degree 6)
_LOG1P_SMALL = _f32(0x3ED413CD)        # sqrt(2) - 1
_LOG1P_N = tuple(_f32(b) for b in (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                                   0x4273CC76, 0x426473AD, 0x41A05101))
_LOG1P_Q = tuple(_f32(b) for b in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                                   0x43586D8A, 0x42707982))
# log(y) (Cephes' logf): y = m * 2**e with m in [sqrt(1/2), sqrt(2)), then a
# degree-8 polynomial in x = m - 1 and e * ln 2 in two parts
_SQRTHF = _f32(0x3F3504F3)
_LOG_P = tuple(_f32(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F,
                                 0x3E11E9BF, 0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC,
                                 0x3EAAAAAA))
_LOG_Q1, _LOG_Q2 = _f32(0xB95E8083), _f32(0x3F318000)
_FLT_MIN = _f32(0x00800000)
# Giles' single-precision ErfInv: coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = tuple(_f32(b) for b in (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1,
                                      0x396532DB, 0xBAA45408, 0xBB88E4EF, 0x3E7C8F63,
                                      0x3FC02E2F))
_ERFINV_GE5 = tuple(_f32(b) for b in (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7,
                                      0x3BBC127B, 0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB,
                                      0x40354F7E))
SQRT2 = _f32(0x3FB504F3)
NORMAL_LO = _f32(0xBF7FFFFF)           # nextafter(-1, 0) in float32


def _log(y: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU backend emits it (Cephes' logf with
    its multiply-adds fused where the compiled code fuses them)."""
    bits = torch.clamp_min(y, _FLT_MIN).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    e = e - small.to(torch.float32)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z = x * x
    x3 = z * x
    p = _LOG_P
    ya = fma32(fma32(x, p[0], p[1]), x, p[2])
    yb = fma32(fma32(x, p[3], p[4]), x, p[5])
    yc = fma32(fma32(x, p[6], p[7]), x, p[8])
    r = fma32(x3, fma32(x3, fma32(x3, ya, yb), yc), e * _LOG_Q1)
    r = fma32(e, _LOG_Q2, (x - 0.5 * z) + r)
    r = torch.where((y < 0) | torch.isnan(y), torch.nan, r)
    r = torch.where(y == torch.inf, torch.inf, r)
    return torch.where(y == 0, -torch.inf, r)


def _log1p(t: torch.Tensor) -> torch.Tensor:
    """float32 log1p as XLA's CPU backend emits it: a rational polynomial
    for |t| < sqrt(2) - 1, else log(1 + t)."""
    t2 = t * t
    q = t + _LOG1P_Q[0]
    for c in _LOG1P_Q[1:]:
        q = fma32(q, t, c)
    n = torch.full_like(t, _LOG1P_N[0])
    for c in _LOG1P_N[1:]:
        n = fma32(n, t, c)
    near = t + (((t * t2) * div32(n, q)) - 0.5 * t2)
    return torch.where(t.abs() < _LOG1P_SMALL, near, _log(t + 1.0))


def div32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a / b``, correctly rounded on every device: the quotient in
    float64 rounded once more (at 53 bits a double rounding of +, -, *, /
    and sqrt to 24 bits is the correct one)."""
    return (a.double() / b.double()).to(torch.float32)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device. torch's CPU
    sqrt is not (torch 2.13 CPU build, AVX-512: 0.7% of float32 and float64
    roots are one ulp off), so the float64 root rounded to float32 is only a
    candidate within an ulp, moved to the neighbour whose half-ulp interval
    holds the root (each midpoint has 25 bits, so its square is exact in
    float64). The one-element call first makes torch pick its kernel: the
    first call that several CPU threads share can run one thread's part on
    another kernel, about 1e-4 off."""
    x64 = x.double()
    torch.sqrt(x64.new_ones(1))
    s = torch.sqrt(x64).to(torch.float32)
    up = torch.nextafter(s, torch.full_like(s, torch.inf))
    dn = torch.nextafter(s, torch.full_like(s, -torch.inf))
    s64 = s.double()
    hi = (s64 + up.double()) / 2
    lo = (s64 + dn.double()) / 2
    fixed = torch.where(hi * hi < x64, up, torch.where(lo * lo > x64, dn, s))
    return torch.where(x64 > 0, fixed, s)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, bit for bit the ``lax.erf_inv`` that
    XLA's CPU backend (jax 0.9.0, x86-64 with FMA) compiles inside
    ``jax.random.normal``: Giles' two-branch polynomial in
    ``w = -log1p(-x * x)`` (``w < 5`` selects the first), Horner steps fused
    into FMAs, ``log1p`` as :func:`_log1p`; +-inf at +-1."""
    x = x.to(torch.float32)
    w = -_log1p(x * -x)
    lt5 = w < 5.0
    ww = torch.where(lt5, w - 2.5, sqrt32(w) - 3.0)
    c = [torch.where(lt5, a, b).to(torch.float32)
         for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = fma32(c[0], ww, c[1])
    for ck in c[2:]:
        p = fma32(p, ww, ck)
    p = torch.where(x.abs() == 1.0, torch.inf, p)
    return x * p


def unit_to_normal(floats: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) (:func:`bits_to_unit_float`) -> the
    standard normals ``jax.random.normal`` builds from the same bits."""
    return erf_inv(unit_to_range(floats, NORMAL_LO, 1.0)) * SQRT2


def normal(key: KeyLike, shape: Sequence[int], device="cpu", *,
           offset: int = 0) -> torch.Tensor:
    """float32 standard normals of ``shape``, as
    ``jax.random.normal(key, shape, float32)``: ``sqrt(2) * erf_inv(u)`` of
    ``u = uniform(key, shape, minval=nextafter(-1, 0), maxval=1)``; a batch
    of keys (..., 2) gives (..., *shape). ``offset`` draws the window of a
    longer draw's flat elements that starts there (:func:`random_bits`)."""
    return unit_to_normal(bits_to_unit_float(
        random_bits(key, shape, device, offset=offset)))


BF16_TINY = 2.0 ** -126                # jnp.finfo(bfloat16).tiny


def gumbel(key: KeyLike, shape: Sequence[int], device="cpu",
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gumbel draws of ``shape``, as ``jax.random.gumbel(key, shape, dtype)``
    in its default ("low") mode: ``-log(-log(u))`` of
    ``u = uniform(key, shape, minval=tiny, maxval=1)``, with ``log`` the
    float32 log that XLA's CPU backend compiles (:func:`_log`). For
    bfloat16 the uniform's 7 mantissa bits are the top 7 of each word's low
    byte (the reference draws 8 bits for a type of fewer than 8 mantissa
    bits), and each step is computed in float32 and
    rounded to bfloat16, as XLA's CPU backend runs bfloat16 arithmetic."""
    if dtype == torch.float32:
        u = uniform(key, shape, device, minval=_FLT_MIN, maxval=1.0)
        return -_log(-_log(u))
    if dtype != torch.bfloat16:
        raise TypeError(f"gumbel takes float32 or bfloat16, not {dtype}")
    bits = random_bits(key, shape, device) & 0xFF
    pattern = ((bits >> 1) | 0x3F80).to(torch.int16)
    floats = pattern.view(torch.bfloat16) - 1.0
    tiny = torch.tensor(BF16_TINY, dtype=torch.bfloat16, device=floats.device)
    span = torch.tensor(1.0, dtype=torch.bfloat16, device=floats.device) - tiny
    u = torch.maximum(tiny, (floats.float() * span.float() + tiny.float())
                      .to(torch.bfloat16))
    inner = (-_log(u.float())).to(torch.bfloat16)
    return (-_log(inner.float())).to(torch.bfloat16)


def categorical(key: KeyLike, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` (..., n), as
    ``jax.random.categorical(key, logits)``: the argmax over the last axis
    of ``logits + gumbel(key, logits.shape, logits.dtype)`` (the first index
    on ties, as ``jnp.argmax``). Returns int64 indices of shape (...)."""
    g = gumbel(key, tuple(logits.shape), logits.device, logits.dtype)
    return torch.argmax(g + logits, dim=-1)


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
