"""64-bit integer arithmetic as pairs of uint32 lanes.

Every u64 quantity in the pipeline (hashes, thresholds) is carried as
(hi, lo) uint32 arrays, so the package runs without jax_enable_x64.
All ops are wrapping mod 2^64, matching C uint64_t semantics.

Multiplication builds on 16-bit limb products so every partial product
fits a uint32 lane (32-bit wrapping multiplies).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

_U32 = jnp.uint32
_MASK16 = 0xFFFF  # plain int: avoids a captured constant in Pallas kernels


class U64(NamedTuple):
    """A 64-bit unsigned integer as two uint32 arrays."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def u64(hi: int, lo: int) -> U64:
    return U64(jnp.uint32(hi), jnp.uint32(lo))


def from_scalar(x: int) -> U64:
    x &= (1 << 64) - 1
    return u64(x >> 32, x & 0xFFFFFFFF)


def from_u32(x: jnp.ndarray) -> U64:
    x = x.astype(_U32)
    return U64(jnp.zeros_like(x), x)


def to_py(x: U64) -> int:
    """Host-side conversion (testing only)."""
    return (int(x.hi) << 32) | int(x.lo)


def mul32x32_64(x: jnp.ndarray, y: jnp.ndarray) -> U64:
    """Full 64-bit product of two uint32 values via 16-bit limbs."""
    x = x.astype(_U32)
    y = y.astype(_U32)
    x0 = x & _MASK16
    x1 = x >> 16
    y0 = y & _MASK16
    y1 = y >> 16
    p00 = x0 * y0
    p01 = x0 * y1
    p10 = x1 * y0
    p11 = x1 * y1
    t = (p00 >> 16) + (p01 & _MASK16) + (p10 & _MASK16)
    lo = (p00 & _MASK16) | (t << 16)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (t >> 16)
    return U64(hi, lo)


def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(_U32)
    return U64(a.hi + b.hi + carry, lo)


def add_u32(a: U64, b: jnp.ndarray) -> U64:
    b = jnp.asarray(b, _U32)
    lo = a.lo + b
    carry = (lo < b).astype(_U32)
    return U64(a.hi + carry, lo)


def mul(a: U64, b: U64) -> U64:
    """Wrapping 64x64 -> low 64 product."""
    ll = mul32x32_64(a.lo, b.lo)
    cross = a.lo * b.hi + a.hi * b.lo  # wrapping: only low 32 needed
    return U64(ll.hi + cross, ll.lo)


def mul_u32(a: jnp.ndarray, b: U64) -> U64:
    """Wrapping product of a uint32 value with a 64-bit constant."""
    a = jnp.asarray(a, _U32)
    ll = mul32x32_64(a, b.lo)
    return U64(ll.hi + a * b.hi, ll.lo)


def xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def shr(a: U64, n: int) -> U64:
    """Logical right shift by a static 0 < n < 64."""
    if n == 0:
        return a
    if n >= 32:
        return U64(jnp.zeros_like(a.hi), a.hi >> (n - 32) if n > 32 else a.hi)
    return U64(a.hi >> n, (a.lo >> n) | (a.hi << (32 - n)))


def shl(a: U64, n: int) -> U64:
    if n == 0:
        return a
    if n >= 32:
        return U64(a.lo << (n - 32) if n > 32 else a.lo, jnp.zeros_like(a.lo))
    return U64((a.hi << n) | (a.lo >> (32 - n)), a.lo << n)


def rotl(a: U64, n: int) -> U64:
    n &= 63
    if n == 0:
        return a
    if n == 32:
        return U64(a.lo, a.hi)
    if n < 32:
        return U64((a.hi << n) | (a.lo >> (32 - n)),
                   (a.lo << n) | (a.hi >> (32 - n)))
    n -= 32
    return U64((a.lo << n) | (a.hi >> (32 - n)),
               (a.hi << n) | (a.lo >> (32 - n)))


def lt(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def le(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo <= b.lo))


def eq(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi == b.hi) & (a.lo == b.lo)


def gt(a: U64, b: U64) -> jnp.ndarray:
    return lt(b, a)


def where(c: jnp.ndarray, a: U64, b: U64) -> U64:
    return U64(jnp.where(c, a.hi, b.hi), jnp.where(c, a.lo, b.lo))
