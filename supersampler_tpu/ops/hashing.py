"""Vectorized XXHash64 for fixed 8-byte little-endian inputs, seed 1312.

Bit-identical to the reference's minimizer hash (reference
utils.cpp:244-249 -> include/xxhash64.h:158-163 with length == 8:
h = seed + Prime5 + 8; one 8-byte round; final avalanche). Carried in
uint32 limb pairs (ops/u64.py), so no 64-bit integer types are
needed on the device.

The minimizer inputs are 2m-bit values (m <= 15 -> fits uint32), so the
fast path takes a uint32 array directly.
"""

from __future__ import annotations

import jax.numpy as jnp

from supersampler_tpu.core.scalar import PRIME1, PRIME2, PRIME3, PRIME4, PRIME5, SEED
from supersampler_tpu.ops import u64 as U

_H0_INT = (SEED + PRIME5 + 8) & ((1 << 64) - 1)


def _consts():
    """Constants built per trace so Pallas kernels don't capture
    module-level arrays."""
    return (U.from_scalar(PRIME1), U.from_scalar(PRIME2),
            U.from_scalar(PRIME3), U.from_scalar(PRIME4),
            U.from_scalar(_H0_INT))


def _finalize(h: U.U64, p2: U.U64, p3: U.U64) -> U.U64:
    h = U.xor(h, U.shr(h, 33))
    h = U.mul(h, p2)
    h = U.xor(h, U.shr(h, 29))
    h = U.mul(h, p3)
    h = U.xor(h, U.shr(h, 32))
    return h


def xxh64_u64(x: U.U64) -> U.U64:
    """Hash of a general 64-bit value (as uint32 pair arrays)."""
    p1, p2, p3, p4, h0c = _consts()
    single = U.mul(U.rotl(U.mul(x, p2), 31), p1)
    h0 = U.U64(jnp.broadcast_to(h0c.hi, single.hi.shape).astype(jnp.uint32),
               jnp.broadcast_to(h0c.lo, single.lo.shape).astype(jnp.uint32))
    h = U.add(U.mul(U.rotl(U.xor(h0, single), 27), p1), p4)
    return _finalize(h, p2, p3)


def xxh64_u32(x: jnp.ndarray) -> U.U64:
    """Fast path: hash of a value known to fit 32 bits (minimizers)."""
    p1, p2, p3, p4, h0c = _consts()
    single = U.mul(U.rotl(U.mul_u32(x, p2), 31), p1)
    h0 = U.U64(jnp.broadcast_to(h0c.hi, single.hi.shape).astype(jnp.uint32),
               jnp.broadcast_to(h0c.lo, single.lo.shape).astype(jnp.uint32))
    h = U.add(U.mul(U.rotl(U.xor(h0, single), 27), p1), p4)
    return _finalize(h, p2, p3)
